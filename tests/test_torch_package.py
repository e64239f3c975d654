"""Hygiene of the PyTorch port ``dlrover_tpu_torch``: it imports neither JAX
nor the JAX package, its entry points never drop to the CPU on their own,
options that later slices bring are refused loudly, and its configurations
and parameter tree match the JAX package's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.ops import quant as tquant
from dlrover_tpu_torch import serve as tserve

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dlrover_tpu_torch"
CHIP_SMOKE = REPO / "chip_smoke.py"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


@pytest.fixture(scope="module")
def tiny():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    return cfg, params


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "dlrover_tpu"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, dlrover_tpu_torch, dlrover_tpu_torch.serve, "
        "dlrover_tpu_torch.train, dlrover_tpu_torch.models.convert, "
        "dlrover_tpu_torch.ops.quant, dlrover_tpu_torch.optim\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dlrover_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_raises_without_cuda(no_cuda):
    cfg = tllama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tllama.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tinfer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--config", "tiny"])
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_quant_op_runs_on_cuda_by_default(no_cuda):
    """``quantize_blockwise`` puts an array on the CUDA device unless the
    caller passes ``device="cpu"``, and a CPU tensor never reaches the
    kernel's backend."""
    x = np.ones(300, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tquant.quantize_blockwise(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tquant.quantize_blockwise(torch.from_numpy(x), backend="cuda")
    codes, scale = tquant.quantize_blockwise(x, device="cpu")
    assert codes.device.type == "cpu" and tuple(codes.shape) == (3, 128)


def test_chip_smoke_fails_without_cuda(no_cuda, tmp_path):
    """On a host without a card, and alone in a directory, the smoke
    exits non-zero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(CHIP_SMOKE.read_bytes())
    for cwd, script in ((REPO, CHIP_SMOKE), (tmp_path, alone)):
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=120,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("kw", [
    {"paged": True}, {"quant_kv": True}, {"decode_chunk": 2},
    {"spec_remote": True}, {"draft": ({}, None)},
])
def test_server_refuses_later_slice_options(tiny, kw):
    cfg, params = tiny
    with pytest.raises(NotImplementedError, match="later serving slice"):
        tinfer.DecodeServer(params, cfg, **kw)


def test_other_later_slice_paths_are_refused(tiny):
    cfg, params = tiny
    srv = tinfer.DecodeServer(params, cfg, slots=1, max_len=32)
    p = np.ones(4, np.int32)
    with pytest.raises(NotImplementedError, match="shared_prefix"):
        srv.serve([p], 2, shared_prefix=p)
    with pytest.raises(NotImplementedError, match="prefix_len"):
        srv.submit("a", p, 2, prefix_len=2)
    with pytest.raises(NotImplementedError, match="quant_kv"):
        tinfer.init_cache(cfg, 1, 8, device="cpu", quant_kv=True)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.LlamaConfig.tiny(num_experts=4)
    x = torch.zeros(1, 2, cfg.d_model)
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match=impl):
            tllama.block_apply(params["layers"][0], x, cfg,
                               torch.zeros(1, 2, dtype=torch.long),
                               attn_impl=impl)
    with pytest.raises(ValueError, match="decode_chunk"):
        tinfer.DecodeServer(params, cfg, decode_chunk=0)


def test_server_rejects_bad_prompts(tiny):
    cfg, params = tiny
    srv = tinfer.DecodeServer(params, cfg, slots=1, max_len=32)
    for bad in (np.zeros(0, np.int32), np.array([1, cfg.vocab_size]),
                np.array([[1, 2]]), np.array([-1])):
        with pytest.raises(ValueError):
            srv.submit("a", bad, 2)
    assert srv.pending_count() == 0


@pytest.mark.parametrize("name", ["llama2_7b", "tiny", "small_300m",
                                  "medium_800m"])
def test_configs_match_jax(name):
    j = getattr(jllama.LlamaConfig, name)()
    t = getattr(tllama.LlamaConfig, name)()
    for f in ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model",
              "d_ff", "max_seq_len", "rope_theta", "rms_eps",
              "sliding_window", "num_experts", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def test_init_params_tree_matches_jax():
    jcfg = jllama.LlamaConfig.tiny(n_layer=3, d_model=128, d_ff=256)
    tcfg = tllama.LlamaConfig.tiny(n_layer=3, d_model=128, d_ff=256)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tllama.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert list(tflat) == list(jflat)
    for path, jv in jflat.items():
        tv = tflat[path]
        assert tuple(tv.shape) == jv.shape, path
        name = jax.tree_util.keystr(path)
        if "ln" in name:
            assert tv.dtype == torch.float32 and bool((tv == 1).all())
        else:
            assert tv.dtype == tcfg.dtype
            std = float(tv.float().std())
            assert abs(std - 0.02) < 0.002, (name, std)


def test_serve_cli_runs_on_cpu(capsys):
    assert tserve.main(["--config", "tiny", "--device", "cpu",
                        "--requests", "3", "--slots", "2",
                        "--max_new_tokens", "4"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("SERVE_DONE") and "new_tokens=12" in line
    assert "rmsnorm_launches=0" in line


def test_serve_requests_match_reference_stream():
    import examples.serve_common as ref

    cfg = tllama.LlamaConfig.tiny()
    a, _ = tserve.seeded_requests(cfg, 7, 3)
    b, _ = ref.seeded_requests(cfg, 7, 3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
