"""The host side of the port's RMSNorm, cross-entropy and quantize wrappers
(``dlrover_tpu_torch/ops/_launch.py``), on the CPU.

A kernel runs only on the card; what is checked here is what the wrappers
do before they reach it: every check of the old call raises its old
exception type for a bad input before the kernel's library is even bound,
a tensor on neither the CPU nor a CUDA device raises, the cross-entropy
route follows from the shape alone, and the build compiles a kernel's
``.cu`` files while its headers count in the library's hash.  The calls
themselves (stream, device, fresh outputs, launch counts) are tested on the
card by ``tests/test_torch_cuda.py``.
"""

import subprocess

import pytest
import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import cross_entropy as xent
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.ops import rmsnorm as rms


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reached(Exception):
    """Raised in place of binding a kernel's library."""


@pytest.fixture
def no_kernel(monkeypatch):
    """Every wrapper's library binding raises :class:`_Reached`."""
    def reached():
        raise _Reached

    for mod in (rms, xent, quant):
        monkeypatch.setattr(mod, "_kernel_fn", reached)


X = torch.zeros(4, 64)
W = torch.ones(64)

RMSNORM_ERRORS = {
    "fp16 x": ((X.half(), W), TypeError),
    "bf16 gain": ((X, W.bfloat16()), TypeError),
    "gain shape": ((X, torch.ones(63)), TypeError),
    "strided x": ((X.t(), torch.ones(4)), ValueError),
    "empty last dim": ((torch.zeros(4, 0), torch.ones(0)), ValueError),
    "strided gain": ((X, torch.ones(128)[::2]), ValueError),
}


@pytest.mark.parametrize("case", RMSNORM_ERRORS)
def test_rmsnorm_checks_raise_before_the_kernel(no_kernel, case):
    (x, w), err = RMSNORM_ERRORS[case]
    before = rms.rmsnorm.launches
    with pytest.raises(err):
        rms._launch_kernel(x, w, 1e-6)
    assert rms.rmsnorm.launches == before


L = torch.zeros(4, dtype=torch.long)

XENT_ERRORS = {
    "fp16 logits": ((X.half(), L), TypeError),
    "float labels": ((X, L.float()), TypeError),
    "label shape": ((X, L[:3]), ValueError),
    "empty vocab": ((torch.zeros(4, 0), L), ValueError),
    "strided logits": ((X.t(), torch.zeros(64, dtype=torch.long)),
                       ValueError),
}


@pytest.mark.parametrize("case", XENT_ERRORS)
def test_xent_checks_raise_before_the_kernel(no_kernel, case):
    (logits, labels), err = XENT_ERRORS[case]
    before = xent.xent_fwd.launches
    with pytest.raises(err):
        xent._launch_kernel(logits, labels)
    assert xent.xent_fwd.launches == before


def test_quant_kernel_refuses_a_cpu_tensor_before_the_kernel(no_kernel):
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant._launch_kernel(torch.ones(300))
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant.quantize_blockwise(torch.ones(300), backend="cuda")


@pytest.mark.parametrize("call", [
    lambda: rms._launch_kernel(X, W, 1e-6),
    lambda: xent._launch_kernel(X, L),
], ids=["rmsnorm", "xent"])
def test_good_inputs_pass_every_check(no_kernel, call):
    """Inputs the kernel takes get past every check to the binding."""
    with pytest.raises(_Reached):
        call()


@pytest.mark.parametrize("call", [
    lambda x: rms.rmsnorm(x, torch.ones(64, device="meta")),
    lambda x: xent.xent_fwd(x, torch.zeros(4, dtype=torch.long,
                                           device="meta")),
    lambda x: quant.quantize_blockwise(x),
], ids=["rmsnorm", "xent", "quant"])
def test_other_devices_raise(no_kernel, call):
    with pytest.raises(ValueError, match="cuda"):
        call(torch.zeros(4, 64, device="meta"))


@pytest.mark.parametrize("rows,V,esize,want", [
    (8192, 32000, 4, "cluster"),
    (8192, 32000, 2, "cluster"),
    (8192, 32001, 4, "cluster"),
    (128, 256, 4, "cluster"),
    (16, 65536, 4, "cluster"),
    (16, 65537, 4, "two_pass"),
    (16, 131072, 2, "cluster"),
    (16, 131073, 2, "two_pass"),
    (1024, 128256, 4, "two_pass"),
    (1024, 128256, 2, "cluster"),
    (8, 262144, 2, "two_pass"),
    (2 ** 28 - 1, 256, 4, "cluster"),
    (2 ** 28, 256, 4, "two_pass"),
])
def test_xent_route_follows_the_shape(rows, V, esize, want):
    """The cluster route takes a row whose V elements fit 8 CTAs of 32 KB
    each, at up to 2**31 / 8 rows (its grid has 8 CTAs a row)."""
    assert xent.route(rows, V, esize) == want


def test_build_compiles_the_units_and_hashes_the_headers(tmp_path,
                                                         monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in rms.SOURCES:
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmds = []

    def run(cmd, **_):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", run)
    first = _build.build("rmsnorm", rms.SOURCES)
    assert cmds[0][-1] == str(csrc / "rmsnorm.cu")
    assert not any(a.endswith(".cuh") for a in cmds[0])
    assert _build.build("rmsnorm", rms.SOURCES) == first and len(cmds) == 1
    (csrc / "launch.cuh").write_text("// changed\n")
    second = _build.build("rmsnorm", rms.SOURCES)
    assert second != first and len(cmds) == 2
