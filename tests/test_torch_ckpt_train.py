"""Flash checkpointing through the port's training entry point
(``python -m dlrover_tpu_torch.train --ckpt_dir``), the counterpart of
``examples/llama_train.py:204-259``, and a checkpoint of the JAX package
read by the port.

(g) A tiny-model run is SIGKILLed after a save to memory; a run restarted
on the same directory restores from the shm arena it left, a run on a
copy of the directory (whose arena namespace holds nothing) restores from
storage, and each reaches the uninterrupted run's final loss exactly (the
same fp32 arithmetic in the same order: equality, not a tolerance).

(h) The reference's ``CheckpointEngine`` saves the tiny JAX model; the
port's engine reads it, ``models/convert.py`` carries it into the port's
tree (the same tensors as a load into that tree), and the port's loss
equals the JAX loss within ``tests/test_torch_train.py``'s tolerance
(atol 1e-5: the same fp32 arithmetic, summed in another order)."""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch import train as ttrain
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.common.shm import arena_name, unlink_arena
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.parallel.accelerate import tree_leaves

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
STEPS, FIRST, INTERVAL = 60, 20, 10
CHILD_TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(ckpt_dir=None, steps=STEPS):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update(OMP_NUM_THREADS="1", DLROVER_TPU_LOG_LEVEL="WARNING")
    argv = [sys.executable, "-m", "dlrover_tpu_torch.train", "--model",
            "tiny", "--device", "cpu", "--steps", str(steps)]
    if ckpt_dir:
        argv += ["--ckpt_dir", str(ckpt_dir), "--ckpt_interval",
                 str(INTERVAL)]
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    done = [ln for ln in out.splitlines() if ln.startswith("TRAIN_DONE")]
    stats = [ln for ln in out.splitlines() if ln.startswith("CKPT_STATS")]
    fields = dict(kv.split("=", 1) for kv in done[-1].split()[1:])
    restored = [ln for ln in out.splitlines() if "restored step=" in ln]
    return fields, (json.loads(stats[-1].split(" ", 1)[1]) if stats
                    else None), restored


def test_sigkill_then_warm_and_cold_restore_reach_the_same_loss(tmp_path):
    d, cold = tmp_path / "ckpt", tmp_path / "ckpt_cold"
    arenas = [arena_name(ttrain.ckpt_job_name(str(p)), 0) for p in (d, cold)]
    procs = []
    try:
        procs.append(_train())  # the uninterrupted run
        first = _train(d, FIRST)
        procs.append(first)
        assert _finish(first)[0]["step"] == str(FIRST)
        killed = _train(d)
        procs.append(killed)
        lines = []
        for line in killed.stdout:
            lines.append(line)
            if "saved step=" in line and "restored" not in line:
                os.kill(killed.pid, signal.SIGKILL)
                break
        killed.communicate(timeout=CHILD_TIMEOUT)
        assert killed.returncode == -signal.SIGKILL
        assert f"restored step={FIRST}" in lines[0]
        saved = int(lines[-1].split("saved step=")[1].split()[0])
        assert saved > FIRST and not any("TRAIN_DONE" in ln for ln in lines)
        # The copy holds the storage of the first run only, and no arena
        # exists for its namespace.
        shutil.copytree(d, cold, copy_function=os.link)
        warm_p, cold_p = _train(d), _train(cold)
        procs += [warm_p, cold_p]
        want, _, _ = _finish(procs[0])
        warm, warm_stats, warm_restored = _finish(warm_p)
        cold_run, cold_stats, cold_restored = _finish(cold_p)
        assert warm_stats["restore_source"] == "shm"
        assert int(warm["restored_step"]) >= saved
        assert warm_restored == [f"[worker 0] restored step="
                                 f"{warm['restored_step']}"]
        assert cold_stats["restore_source"] == "storage"
        assert cold_run["restored_step"] == str(FIRST)
        assert cold_restored == [f"[worker 0] restored step={FIRST}"]
        for run in (warm, cold_run):
            assert run["step"] == str(STEPS)
            assert run["loss"] == want["loss"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for name in arenas:
            unlink_arena(name)


def test_port_loads_a_checkpoint_of_the_jax_package(tmp_path, monkeypatch):
    job = f"jaxsave-{os.getpid()}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_TPU_RUN_ID", f"run-{job}")
    monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
    from dlrover_tpu.checkpoint.engine import CheckpointEngine as JEngine

    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    d = str(tmp_path / "ckpt")
    jeng = JEngine(d, job_name=job)
    try:
        jeng.save_to_storage(3, {"params": jp}, {"step": 3})
        assert jeng.wait(60)
    finally:
        jeng.close()
        unlink_arena(jeng._arena.name)

    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(5),
                                "cpu", param_dtype=torch.float32)
    eng = CheckpointEngine(d, job_name=f"port-{job}")
    try:
        # Without a target: {path: tensor}, carried into the port's tree
        # by models/convert.py.
        source, meta = eng.load()
        assert meta["step"] == 3 and eng.last_restore_source == "storage"
        paths, treedef = jax.tree_util.tree_flatten_with_path(jp)
        tree = jax.tree_util.tree_unflatten(treedef, [
            source["['params']" + jax.tree_util.keystr(p)].numpy()
            for p, _ in paths])
        converted = params_from_numpy(tree, tcfg, device="cpu",
                                      param_dtype=torch.float32)
        # With the port's own tree as the target: copied into it.
        target = {"params": params}
        restored, _ = eng.load(target)
        assert restored is target
    finally:
        eng.close()
        unlink_arena(eng.arena.name)
    for a, b in zip(tree_leaves(converted), tree_leaves(params)):
        assert torch.equal(a, b)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, tcfg.vocab_size, size=(2, 17)).astype(np.int32)
    want = jax.jit(lambda p, b: jllama.loss_fn(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = tllama.loss_fn(converted,
                             {"tokens": torch.from_numpy(tokens)}, tcfg)
    assert abs(float(got) - float(want)) <= ATOL
