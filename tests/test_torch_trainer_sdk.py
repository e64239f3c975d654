"""The trainer SDK of the port (``dlrover_tpu_torch/trainer/{elastic,
trainer}.py`` and the package's re-exports) against the reference's
(``dlrover_tpu/trainer/{elastic,trainer}.py``):

- ``resolve_grad_accum`` (hypothesis over the global batch, the world and
  the micro ceiling, its ``ValueError`` included);
- ``build_lr_schedule`` for each schedule, with and without warmup, at
  every step against the optax schedule (rtol 1e-6);
- ``Trainer`` on the tiny Llama (2 layers, fp32; the reference on one CPU
  device) with clipping engaged, a warmup whose first update runs at LR
  0, weight decay, eval and logging cadences and two epochs: each step's
  loss and gradient norm (atol 1e-5, as ``tests/test_torch_train.py``),
  the LR each update ran at (rtol 1e-6), the eval losses (atol 1e-5),
  ``TrainerState.to_meta()`` and the ``log_history`` keys;
- in the port, a run stopped after its save at step k and resumed by a new
  ``Trainer`` equals the uninterrupted run exactly, mid-epoch and at an
  epoch boundary;
- ``EarlyStoppingCallback``; ``ElasticDataLoader`` with a batch size the
  port's master pushes; the refusals by name."""

import dataclasses
import hashlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import dlrover_tpu.trainer as rsdk
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.accelerate import Strategy as RStrategy
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu.trainer import elastic as relastic
from dlrover_tpu.trainer import trainer as rtrainer
from dlrover_tpu.trainer.sampler import ElasticSampler as RSampler
import dlrover_tpu_torch.trainer as sdk
from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.shm import arena_name, unlink_arena
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.parallel.accelerate import Strategy
from dlrover_tpu_torch.trainer import elastic as telastic
from dlrover_tpu_torch.trainer import trainer as ttrainer

ATOL = 1e-5
RTOL_LR = 1e-6
STEPS = 6

ARGS = dict(global_batch_size=4, max_micro_batch_per_proc=2,
            max_steps=STEPS, learning_rate=1e-3, lr_schedule="cosine",
            warmup_steps=2, min_lr_ratio=0.1, weight_decay=0.05,
            max_grad_norm=1.0, logging_steps=2, eval_steps=3, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- resolve_grad_accum and the schedule --------------------------------------

def _call(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 512), st.integers(1, 16), st.integers(1, 64))
def test_resolve_grad_accum_matches_the_reference(gbs, world, micro):
    got = _call(telastic.resolve_grad_accum, gbs, world, micro)
    assert got == _call(relastic.resolve_grad_accum, gbs, world, micro)
    if not isinstance(got[0], str):
        assert got[0] * got[1] * world == gbs and got[0] <= micro


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_lr_schedule_matches_optax(kind, warmup):
    kw = dict(learning_rate=3e-4, lr_schedule=kind, warmup_steps=warmup,
              min_lr_ratio=0.1)
    total = 20
    port = ttrainer.build_lr_schedule(ttrainer.TrainingArgs(**kw), total)
    ref = rtrainer.build_lr_schedule(rtrainer.TrainingArgs(**kw), total)
    got = np.array([port(s) for s in range(total + 5)])
    want = np.array([float(ref(s)) for s in range(total + 5)])
    np.testing.assert_allclose(got, want, rtol=RTOL_LR, atol=0)
    if warmup:
        assert got[0] == 0.0
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        ttrainer.build_lr_schedule(ttrainer.TrainingArgs(lr_schedule="x"), 5)


# -- the Trainer against the reference's ---------------------------------------

ROWS = np.random.RandomState(0).randint(0, 256, size=(64, 17)).astype(
    np.int32)


def fetch(indices):
    return {"tokens": ROWS[np.asarray(indices) % 32]}


def eval_fetch(indices):
    return {"tokens": ROWS[32 + np.asarray(indices) % 32]}


class Record(sdk.TrainerCallback):
    """Each step's loss and gradient norm, each eval and, for the port,
    the LR the step's update ran at."""

    def __init__(self):
        self.steps, self.evals, self.lrs = {}, {}, {}
        self.trainer = None

    def on_step_end(self, args, state, control, metrics):
        self.steps[state.step] = (float(metrics["loss"]),
                                  float(metrics["grad_norm"]))
        if self.trainer is not None:
            opt = self.trainer.core.state["opt_state"]
            self.lrs[state.step] = opt.param_groups[0]["lr"]

    def on_evaluate(self, args, state, control, metrics):
        self.evals[state.step] = metrics["eval_loss"]


class StopAfterSave(sdk.TrainerCallback):
    def __init__(self, at):
        self.at = at

    def on_save(self, args, state, control):
        if state.step == self.at:
            control.should_stop = True


def port_trainer(callbacks=(), **over):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jcfg = jllama.LlamaConfig.tiny(dtype=jax.numpy.float32)
    tree = jax.tree.map(np.asarray,
                        jllama.init_params(jax.random.PRNGKey(0), jcfg))
    rec = Record()
    trainer = sdk.Trainer(
        loss_fn=lambda p, b: tllama.loss_fn(p, b, tcfg),
        init_fn=lambda g: params_from_numpy(tree, tcfg, device="cpu",
                                            param_dtype=torch.float32),
        args=sdk.TrainingArgs(**{**ARGS, **over}), fetch_batch=fetch,
        dataset_size=8, eval_fetch=eval_fetch, eval_dataset_size=8,
        strategy=Strategy(), callbacks=[rec, *callbacks], devices=["cpu"])
    rec.trainer = trainer
    return trainer, rec


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.LlamaConfig.tiny(dtype=jax.numpy.float32)
    rrec = Record()
    ref = rsdk.Trainer(
        loss_fn=lambda p, b: jllama.loss_fn(p, b, jcfg),
        init_fn=lambda key: jllama.init_params(key, jcfg),
        args=rsdk.TrainingArgs(**ARGS), fetch_batch=fetch, dataset_size=8,
        eval_fetch=eval_fetch, eval_dataset_size=8,
        strategy=RStrategy(mesh=MeshSpec(dp=1)),
        devices=[jax.devices("cpu")[0]], callbacks=[rrec])
    ref.train()
    port, prec = port_trainer()
    port.train()
    return {"ref": ref, "rrec": rrec, "port": port, "prec": prec}


def test_trainer_steps_and_evals_match_the_reference(pair):
    prec, rrec = pair["prec"], pair["rrec"]
    assert sorted(prec.steps) == sorted(rrec.steps) == list(
        range(1, STEPS + 1))
    for s in prec.steps:
        np.testing.assert_allclose(prec.steps[s], rrec.steps[s], rtol=0,
                                   atol=ATOL, err_msg=f"step {s}")
    # Clipping engaged: the reported norms (before clipping) exceed 1.0.
    assert max(g for _, g in prec.steps.values()) > ARGS["max_grad_norm"]
    assert sorted(prec.evals) == sorted(rrec.evals) == [3, 6]
    for s in prec.evals:
        assert abs(prec.evals[s] - rrec.evals[s]) <= ATOL
    # The LR each update ran at: optax reads its count before the update.
    sched = pair["ref"].schedule
    want = np.array([float(sched(s - 1)) for s in sorted(prec.lrs)])
    np.testing.assert_allclose([prec.lrs[s] for s in sorted(prec.lrs)],
                               want, rtol=RTOL_LR, atol=0)
    assert prec.lrs[1] == 0.0


def test_trainer_state_and_log_history_match_the_reference(pair):
    port, ref = pair["port"], pair["ref"]
    pm, rm = port.state.to_meta(), ref.state.to_meta()
    assert abs(pm.pop("best_metric") - rm.pop("best_metric")) <= ATOL
    assert pm == rm
    ph, rh = port.state.log_history, ref.state.log_history
    assert [sorted(h) for h in ph] == [sorted(h) for h in rh]
    for a, b in zip(ph, rh):
        assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=RTOL_LR)
        for k in ("loss", "eval_loss"):
            if k in a:
                assert abs(a[k] - b[k]) <= ATOL
    assert port.current_lr() == pytest.approx(ref.current_lr(), rel=1e-6)


@pytest.mark.parametrize("stop_at", [3, 4], ids=["mid_epoch",
                                                 "epoch_boundary"])
def test_a_stopped_run_resumes_exactly(pair, tmp_path, stop_at):
    """Stopped after its save at ``stop_at`` (two steps an epoch: 4 is an
    epoch's end, and the restored sampler's first pass is empty), a new
    ``Trainer`` on the same directory restores and finishes with the
    uninterrupted run's every value and parameter."""
    ckpt = str(tmp_path / "ck")
    job = "t" + hashlib.sha1(ckpt.encode()).hexdigest()[:10]
    over = dict(ckpt_dir=ckpt, save_steps=1, persist_every_n_saves=100)
    try:
        first, rec1 = port_trainer([StopAfterSave(stop_at)], **over)
        assert first.train().step == stop_at
        second, rec2 = port_trainer(**over)
        second.train()
    finally:
        unlink_arena(arena_name(job, 0))
    want = pair["prec"]
    got_steps = {**{s: v for s, v in rec1.steps.items() if s <= stop_at},
                 **rec2.steps}
    assert got_steps == want.steps
    assert {**rec1.evals, **rec2.evals} == want.evals
    assert {**rec1.lrs, **rec2.lrs} == want.lrs
    assert min(rec2.steps) == stop_at + 1
    live = pair["port"].core.state["params"]
    for a, b in zip(telastic_leaves(second.core.state["params"]),
                    telastic_leaves(live)):
        assert torch.equal(a, b)
    assert second.state.step == STEPS and second.state.saves > 1


def telastic_leaves(tree):
    from dlrover_tpu_torch.parallel.accelerate import tree_leaves

    return tree_leaves(tree)


def test_eval_loss_is_the_groups_mean(monkeypatch):
    """In a data-parallel group each process's eval loss is averaged over
    the group, as the reference's eval over the global batch is (a
    two-process group stood in for by its ``all_reduce``)."""
    trainer, _ = port_trainer()
    trainer.core.build(1, 0)
    local = trainer.evaluate()["eval_loss"]

    def all_reduce(t, group=None):
        t.add_(t + 1.0)  # the other rank's loss is local + 1

    monkeypatch.setattr(ttrainer.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(ttrainer.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(ttrainer.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(ttrainer.dist_env, "host_group", lambda: None)
    assert trainer.evaluate()["eval_loss"] == pytest.approx(local + 0.5,
                                                            abs=1e-9)


# -- callbacks, the data loader, the SDK's names ------------------------------

@pytest.mark.parametrize("patience", [0, 1, 2])
def test_early_stopping_callback_matches_the_reference(patience):
    for since in range(4):
        got, want = sdk.TrainerControl(), rsdk.TrainerControl()
        sdk.EarlyStoppingCallback().on_evaluate(
            sdk.TrainingArgs(early_stopping_patience=patience),
            sdk.TrainerState(evals_since_best=since), got, {})
        rsdk.EarlyStoppingCallback().on_evaluate(
            rsdk.TrainingArgs(early_stopping_patience=patience),
            rsdk.TrainerState(evals_since_best=since), want, {})
        assert got == sdk.TrainerControl(should_stop=want.should_stop)


def test_early_stopping_ends_a_plateau():
    """At LR 0 the eval loss never improves: patience 1 stops the loop
    after the second eval."""
    trainer, rec = port_trainer(learning_rate=0.0, eval_steps=1,
                                early_stopping_patience=1)
    state = trainer.train()
    assert state.step == 2 and trainer.control.should_stop
    assert rec.evals[1] == rec.evals[2] and state.evals_since_best == 1


class _Pushes:
    """The reference loader's client: the port master's configs, as
    the port's client read them."""

    def __init__(self, client):
        self.client = client

    def get_parallel_config(self):
        from dlrover_tpu.common import messages as R

        cfg = self.client.get_parallel_config()
        return R.ParallelConfig(dataloader=dict(cfg.dataloader),
                                version=cfg.version)


def test_elastic_data_loader_takes_the_masters_batch_size():
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import LocalJobMaster

    master = LocalJobMaster(0, job_name="loader")
    master.prepare()
    client = MasterClient(master.addr, 0)
    try:
        port = sdk.ElasticDataLoader(
            sdk.ElasticSampler(12, batch_size_per_process=2, shuffle=False),
            lambda idx: list(idx), master_client=client)
        ref = rsdk.ElasticDataLoader(
            RSampler(12, batch_size_per_process=2, shuffle=False),
            lambda idx: list(idx), master_client=_Pushes(client))
        master.job_manager.set_parallel_config(0, m.ParallelConfig(
            dataloader={"batch_size": 3}, version=1))
        got, want = [], []
        for epoch in range(3):
            its = [iter(port), iter(ref)]
            firsts = [[int(i) for i in next(it)] for it in its]
            if epoch == 1:
                # Mid-epoch: taken at the next epoch's start.
                master.job_manager.set_parallel_config(0, m.ParallelConfig(
                    dataloader={"batch_size": 4}, version=2))
            for it, first, out in zip(its, firsts, (got, want)):
                out.append([first] + [[int(i) for i in b] for b in it])
        assert got == want
        assert [len(e[0]) for e in got] == [3, 3, 4]
    finally:
        client.close()
        master.request_stop(True, "test")
        master.stop()


def test_the_sdk_exports_the_references_names():
    names = {n for n in dir(rsdk) if not n.startswith("_")
             and not isinstance(getattr(rsdk, n), type(dataclasses))}
    assert names <= set(dir(sdk))
    assert dataclasses.fields(sdk.TrainingArgs) and [
        (f.name, f.default) for f in dataclasses.fields(sdk.TrainingArgs)
    ] == [(f.name, f.default) for f in dataclasses.fields(rsdk.TrainingArgs)]


_CACHE = object()


def _elastic(**kw):
    kw.setdefault("strategy", Strategy())
    return sdk.ElasticTrainer(
        sdk.TrainerConfig(4, 2), loss_fn=None, init_fn=None, optimizer=None,
        fetch_batch=fetch, dataset_size=8, devices=kw.pop("devices",
                                                          ["cpu"]), **kw)


@pytest.mark.parametrize("make,match", [
    (lambda: _elastic(strategy=None), "auto"),
    (lambda: _elastic(strategy="auto"), "auto"),
    (lambda: _elastic(param_specs="planner"), None),
    (lambda: _elastic(strategy_cache=_CACHE), "cache"),
    (lambda: _elastic(devices=["cpu", "cpu"]), "devices=.*item 5d"),
    (lambda: _elastic(frozen={}), "frozen=.*item 6"),
    (lambda: _elastic().reshard_live(2, 0), "reshard_live.*host-only"),
    (lambda: port_trainer(layout_planner=True), None),
    (lambda: port_trainer(op_metrics_every=2), "op_metrics.*host-only"),
], ids=["strategy_none", "strategy_auto", "param_specs", "strategy_cache",
        "devices", "frozen", "reshard_live", "layout_planner",
        "op_metrics"])
def test_later_items_are_refused_by_name(make, match):
    """``param_specs=`` and ``TrainingArgs(layout_planner=True)`` came with
    the mesh slice (item 5a): they construct, and ``layout_planner``
    reaches the core as ``param_specs="planner"``.  ``strategy=None`` (the
    search, ``"auto"``), ``"auto"`` and ``strategy_cache=`` came with item
    5b: the core takes them."""
    if match == "auto":
        assert make().base_strategy == "auto"
        return
    if match == "cache":
        assert make().strategy_cache is _CACHE
        return
    if match is None:
        made = make()
        if isinstance(made, tuple):  # port_trainer's (trainer, record)
            made = made[0]
        core = getattr(made, "core", made)
        assert core.param_specs == "planner"
        return
    with pytest.raises(NotImplementedError, match=match):
        make()


def test_the_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _elastic(devices=None)
