"""Hygiene of the PyTorch port ``dlrover_tpu_torch``: it imports neither JAX
nor the JAX package (nor ``msgpack``, ``ml_dtypes`` or ``grpc``: the port
depends on none of them), its entry points never drop to the CPU on their
own, options that later slices bring are refused loudly, and its
configurations and parameter tree match the JAX package's."""

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
from dlrover_tpu_torch.parallel.mesh import Mesh, MeshSpec
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
    bad = _imported_roots(path) & {"jax", "jaxlib", "dlrover_tpu",
                                   "msgpack", "ml_dtypes", "grpc"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, dlrover_tpu_torch, dlrover_tpu_torch.serve, "
        "dlrover_tpu_torch.train, dlrover_tpu_torch.models.convert, "
        "dlrover_tpu_torch.models.decode_graph, "
        "dlrover_tpu_torch.ops.quant, dlrover_tpu_torch.optim, "
        "dlrover_tpu_torch.checkpoint.checkpointer, "
        "dlrover_tpu_torch.checkpoint.fsck, "
        "dlrover_tpu_torch.common.dist_env, "
        "dlrover_tpu_torch.common.multi_process, "
        "dlrover_tpu_torch.reshard.plan, "
        "dlrover_tpu_torch.agent.ckpt_saver, dlrover_tpu_torch.run, "
        "dlrover_tpu_torch.master.main, dlrover_tpu_torch.master.master, "
        "dlrover_tpu_torch.agent.training, "
        "dlrover_tpu_torch.agent.master_client, "
        "dlrover_tpu_torch.diagnosis.agent, dlrover_tpu_torch.common.rpc, "
        "dlrover_tpu_torch.common.messages, "
        "dlrover_tpu_torch.master.dataset_splitter, "
        "dlrover_tpu_torch.master.task_manager, "
        "dlrover_tpu_torch.data.sharding, dlrover_tpu_torch.agent.node_check, "
        "dlrover_tpu_torch.diagnosis.data, "
        "dlrover_tpu_torch.diagnosis.inference, "
        "dlrover_tpu_torch.diagnosis.operators, "
        "dlrover_tpu_torch.diagnosis.manager, "
        "dlrover_tpu_torch.trainer.elastic, dlrover_tpu_torch.trainer.trainer, "
        "dlrover_tpu_torch.parallel.ring_attention, "
        "dlrover_tpu_torch.parallel.sequence, "
        "dlrover_tpu_torch.parallel.strategy_search, "
        "dlrover_tpu_torch.serving, dlrover_tpu_torch.serving.gateway, "
        "dlrover_tpu_torch.serving.replica, dlrover_tpu_torch.serving.draft, "
        "dlrover_tpu_torch.serving.kvseg, dlrover_tpu_torch.serving.autoscale, "
        "dlrover_tpu_torch.agent.metrics, dlrover_tpu_torch.serve_fleet, "
        "dlrover_tpu_torch.serve_elastic, dlrover_tpu_torch.parallel.mesh, "
        "dlrover_tpu_torch.parallel.sharding, "
        "dlrover_tpu_torch.parallel.layout_planner, "
        "dlrover_tpu_torch.parallel.collectives\n"
        "import dlrover_tpu_torch.trainer as sdk\n"
        "assert sdk.Trainer and sdk.init and sdk.ElasticDataLoader\n"
        "from dlrover_tpu_torch.models.llama_infer import ("
        "KvSegmentError, pack_kv_segment, prefix_fingerprint, "
        "unpack_kv_segment)\n"
        "seg, _ = pack_kv_segment([], 1, 0, False)\n"
        "assert unpack_kv_segment(seg)['n'] == 1\n"
        "assert len(prefix_fingerprint([1, 2])) == 16\n"
        "from dlrover_tpu_torch.parallel.mesh import MeshSpec\n"
        "from dlrover_tpu_torch.parallel.layout_planner import plan_layout\n"
        "assert MeshSpec(fsdp=-1).normalized(4).fsdp == 4\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dlrover_tpu', 'msgpack', 'ml_dtypes', "
        "'grpc')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_tier_modules_import_without_jax_or_torch():
    """The tier, spillover, hash ring, auto-scaler and metrics modules
    import neither JAX nor the JAX package, and the gateway side of the
    tier (what a gateway process imports) no torch either."""
    code = (
        "import sys\n"
        "import dlrover_tpu_torch.serving.tier, "
        "dlrover_tpu_torch.serving.spillover, "
        "dlrover_tpu_torch.common.hashring, dlrover_tpu_torch.agent.metrics\n"
        "assert 'torch' not in sys.modules\n"
        "import dlrover_tpu_torch.master.job_auto_scaler\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dlrover_tpu', 'torch')]\n"
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
    from dlrover_tpu_torch import serve_elastic, serve_fleet

    for role in ("replica", "draft", "all"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_fleet.main(["--role", role, "--gateway", "127.0.0.1:1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_elastic.main(["--journal_dir", "unused"])
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
    {"spec_remote": True}, {"draft": "self"},
])
def test_server_refuses_later_slice_options(tiny, kw):
    """Every option of the reference's server now serves on the CPU: the
    paged arena, the int8 cache and chunked decode (serving slice 2), a
    local draft and a spec_remote server with no draft attached (its
    rounds are plain fallbacks); speculation keeps the greedy tokens."""
    cfg, params = tiny
    if kw.get("draft") == "self":
        kw = {"draft": (params, cfg)}
    srv = tinfer.DecodeServer(params, cfg, slots=2, max_len=32, **kw)
    prompts = [np.ones(4, np.int32), np.arange(1, 7)]
    outs = srv.serve(prompts, 5)
    assert [len(o) for o in outs] == [9, 11]
    st = srv.last_stats
    if srv.spec_capable:
        plain = tinfer.DecodeServer(params, cfg, slots=2, max_len=32)
        for a, b in zip(outs, plain.serve(prompts, 5)):
            np.testing.assert_array_equal(a, b)
        assert st["path"] == "spec"
        if "draft" in kw:
            assert st["spec_fallback_rounds"] == 0
            assert st["tokens_per_round"] == 5.0  # the ceiling draft
        else:
            assert st["rounds"] == 0 and st["spec_fallback_rounds"] > 0
        return
    assert st["emitted_tokens"] == 2 * 4


def test_other_later_slice_paths_are_refused(tiny, tmp_path):
    """Prefix caching and the KV-segment handoff (serving slice 2) and
    journaled serving (serving slice 3) serve on the CPU; MoE is still
    refused by name.  The ring and Ulysses attentions came with Queue A
    item 5b: without a mesh they take the flash path, as the reference's
    do, and on a one-rank mesh their own one-block paths."""
    cfg, params = tiny
    srv = tinfer.DecodeServer(params, cfg, slots=1, max_len=32)
    p = np.ones(4, np.int32)
    out = srv.serve([p], 2, shared_prefix=p)[0]
    assert len(out) == 2 * len(p) + 2 and (out[:8] == 1).all()
    srv.submit("a", np.ones(8, np.int32), 2, prefix_len=4)
    assert srv.pending_rids() == ["a"] and srv.cancel("a")
    first = srv.prefill_request("a", p, 2)
    payload, _ = srv.export_kv("a")
    srv.import_kv("a", payload, p, 2)
    assert srv.cancel("a")
    assert 0 <= first < cfg.vocab_size
    journal = str(tmp_path / "j.jsonl")
    outs = tinfer.serve_journaled(srv, [p], 2, journal)
    assert len(outs) == 1 and len(outs[0]) == len(p) + 2
    assert tinfer.serve_journaled(srv, [p], 2, journal,
                                  on_serve=lambda *a: 1 / 0)[0].tolist() \
        == outs[0].tolist()
    cache = tinfer.init_cache(cfg, 1, 8, device="cpu", quant_kv=True)
    assert cache["layers"][0]["k"].dtype == torch.int8
    assert tuple(cache["layers"][0]["ks"].shape) == (1, cfg.n_kv_head, 8)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.LlamaConfig.tiny(num_experts=4)
    x = torch.randn(1, 2, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    pos = torch.arange(2).expand(1, 2)
    flash = tllama.block_apply(params["layers"][0], x, cfg, pos)
    one = Mesh(MeshSpec(), np.arange(1), 0)
    for impl in ("ring", "ulysses"):
        assert torch.equal(tllama.block_apply(
            params["layers"][0], x, cfg, pos, attn_impl=impl), flash)
        got = tllama.block_apply(params["layers"][0], x, cfg, pos,
                                 attn_impl=impl, mesh=one)
        torch.testing.assert_close(got, flash, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="decode_chunk"):
        tinfer.DecodeServer(params, cfg, decode_chunk=0)
    with pytest.raises(ValueError, match="draft"):
        tinfer.DecodeServer(params, cfg, decode_chunk=2, draft=({}, None))


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


def test_fleet_config_names_are_serves():
    """``serve_fleet`` names ``serve.CONFIGS`` without importing torch in
    the gateway; the two lists stay one."""
    from dlrover_tpu_torch import serve_fleet

    assert serve_fleet.CONFIG_NAMES == tuple(sorted(tserve.CONFIGS))


def test_fleet_refuses_the_tier_metrics_and_faults(monkeypatch):
    """The sharded tier, its names and the gateway's Prometheus gauges are
    ported and work; fault injection and the agent's own metrics endpoint
    come with later items and are refused by name."""
    import dlrover_tpu.serving as rserving
    import dlrover_tpu_torch.serving as tserving
    from dlrover_tpu_torch import serve_fleet
    from dlrover_tpu_torch.agent import metrics as tmetrics
    from dlrover_tpu_torch.agent import training
    from dlrover_tpu_torch.common import constants

    # The serving package exports the reference's names, the tier's too.
    public = {n for n in vars(rserving) if not n.startswith("_")}
    assert public <= set(vars(tserving))
    for name in ("TierClient", "TierReplicaLink", "CellSpillRouter",
                 "GatewayTierNode", "ServeRegistry", "merge_snapshots"):
        assert getattr(tserving, name).__module__.startswith(
            "dlrover_tpu_torch.serving.")
    with pytest.raises(AttributeError):
        tserving.NoSuchName  # noqa: B018
    assert "4b" not in constants.QUEUE_A_ITEMS
    assert not hasattr(constants, "SERVING_TIER_ITEM")
    # --registry reaches the tier: a replica still needs the card.
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_fleet.main(["--role", "replica", "--registry",
                              "127.0.0.1:1"])
    with pytest.raises(ValueError, match="--registry"):
        serve_fleet.main(["--role", "draft", "--registry", "127.0.0.1:1"])
    with pytest.raises(ValueError, match="needs --registry"):
        serve_fleet.main(["--role", "gateway", "--metrics_port", "0"])
    # register_gauges exports the gateway's gauges.
    gw = tserving.Gateway(port=0)
    try:
        reg = tmetrics.MetricsRegistry()
        gw.register_gauges(reg)
        assert "dlrover_tpu_serve_completed 0.0" in reg.render()
    finally:
        gw.stop()
    # The agent's DLROVER_TPU_METRICS_PORT stays refused.
    monkeypatch.setenv("DLROVER_TPU_METRICS_PORT", "9100")
    with pytest.raises(NotImplementedError, match="METRICS_PORT"):
        training.ElasticTrainingAgent(training.ElasticLaunchConfig(),
                                      ["true"], "127.0.0.1:1")
    monkeypatch.delenv("DLROVER_TPU_METRICS_PORT")
    monkeypatch.setenv("DLROVER_TPU_FAULTS", "plan.json")
    with pytest.raises(NotImplementedError, match="chaos"):
        serve_fleet.main(["--role", "gateway"])