"""The port's Llama trained sequence-parallel against the reference's
``TestLongContextLlama`` case (``tests/test_parallel.py:1258``).

The tiny fp32 model (``n_head = n_kv_head = 4``) from the reference's
``init_params(PRNGKey(0))``, tokens [2, 65] from ``PRNGKey(1)``, on a
``dp2 x tp2`` mesh: the reference's ``loss_fn(attn_impl="ring" |
"ulysses", mesh=...)`` under ``jax.jit`` (and ``jax.grad`` of it) on four
host devices, the port's in four ``gloo`` children
(``tests/torch_seq_child.py``, one spawn for the module), each rank
holding its row and its 32 positions.  The mean of the four ranks' losses
is the global token mean (each rank's loss is its block's mean, and the
blocks hold the same number of tokens): it must equal the reference's
within ``LOSS_RTOL`` = 2e-5, the reference's own bound against
``attn_impl="reference"``.  The mean of the ranks' gradients (what
``accelerate`` reduces) must equal ``jax.grad`` within ``GRAD_FLOOR`` +
``GRAD_RTOL`` x max|g| = 1e-6 + 1e-5 x max|g| of each leaf (fp32 sums in
another order).

Then ``accelerate`` trains the reference's second case through the
sequence-sharded ``batch_axes=P("dp", "tp")`` for 8 steps with
``adamw(5e-3)`` on tokens [2, 65] below 64: the loss must fall by more
than 0.3, as the reference's does, and the ranks agree on every loss.

Last, the port's one rule where it parts from the reference: a loss cuts
the sequence over ``tp`` only on its own sequence-parallel job's mesh.
The reference's ``Strategy(mesh=MeshSpec(tp=2))`` with a ring loss is
right under its partitioner; in the port the job would not reduce over
``tp``, so that case, a sequence mesh under a job without the sequence
axis, a sequence job whose loss runs the whole sequence, and a ring loss
under ``strategy="auto"`` (timed, or by the cost model) must raise
``ValueError``.  A sequence-parallel job, and a search whose
``loss_fn_builder`` hands each candidate's loss its own mesh, must give
the reference's ring loss on their first step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from dlrover_tpu.models import llama as jllama

import torch_mesh_child as child

LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-5
GRAD_FLOOR = 1e-6
STEPS = 8
IMPLS = ("ring", "ulysses")
_CHILD = child.REPO / "tests" / "torch_seq_child.py"


def _cfg():
    return jllama.LlamaConfig.tiny(n_layer=2, n_head=4, n_kv_head=4,
                                   dtype=jnp.float32, max_seq_len=128)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("seqtrain")
    cfg = _cfg()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    np.savez(work / "params.npz",
             **child.flatten(jax.tree.map(np.asarray, params)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 65),
                                           0, cfg.vocab_size), np.int32)
    np.savez(work / "loss.npz", tokens=tokens[None])
    train = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 65),
                                          0, 64), np.int32)
    np.savez(work / "train.npz", tokens=train[None])
    return work, cfg, params, tokens


@pytest.fixture(scope="module")
def reference(setup, cpu_mesh_devices):
    """``(loss, grads)`` of each impl, and the plain reference loss."""
    _, cfg, params, tokens = setup
    mesh = JMesh(np.array(cpu_mesh_devices[:4]).reshape(2, 2), ("dp", "tp"))

    def both(p, t):
        out = {}
        for impl in IMPLS:
            out[impl] = jax.value_and_grad(lambda q, i=impl: jllama.loss_fn(
                q, {"tokens": t}, cfg, attn_impl=i, mesh=mesh,
                moe_aux_weight=0.0))(p)
        out["reference"] = jllama.loss_fn(p, {"tokens": t}, cfg,
                                          attn_impl="reference",
                                          moe_aux_weight=0.0)
        return out

    with mesh:
        got = jax.jit(both)(params, tokens)
    return jax.tree.map(np.asarray, got)


@pytest.fixture(scope="module")
def port(setup):
    work, *_ = setup
    jobs = [dict(name=f"loss-{impl}", kind="loss", mesh={"dp": 2, "tp": 2},
                 impl=impl, batches=str(work / "loss.npz"))
            for impl in IMPLS]
    jobs += [dict(name="refusals", kind="refusals", mesh={"dp": 2, "tp": 2},
                  batches=str(work / "loss.npz"))]
    jobs += [dict(name=f"train-{impl}", kind="train",
                  mesh={"dp": 2, "tp": 2}, impl=impl, steps=STEPS, lr=5e-3,
                  batches=str(work / "train.npz"),
                  batch_axes=[["dp"], "tp"]) for impl in IMPLS]
    plan = {"device": "cpu", "model": {"n_layer": 2, "n_head": 4,
                                       "n_kv_head": 4, "max_seq_len": 128},
            "params": str(work / "params.npz"), "jobs": jobs}
    recs = child.spawn_world(4, plan, work / "out", timeout=150,
                             script=_CHILD)
    return work, recs


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_matches_the_reference(impl, reference, port):
    _, recs = port
    got = float(np.mean([r["loss"] for r in recs[f"loss-{impl}"]]))
    want = float(reference[impl][0])
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    plain = float(reference["reference"])
    assert abs(got - plain) <= LOSS_RTOL * abs(plain), (got, plain)
    assert all(r["backend"] == "gloo" for r in recs[f"loss-{impl}"])


@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_match_jax_grad(impl, reference, port):
    work, _ = port
    ranks = [dict(np.load(work / "out" / f"loss-{impl}.rank{r}.npz"))
             for r in range(4)]
    want = child.flatten(reference[impl][1])
    assert set(want) == set(ranks[0])
    worst = 0.0
    for key, w in want.items():
        g = np.mean([rk[key] for rk in ranks], axis=0)
        tol = GRAD_FLOOR + GRAD_RTOL * np.abs(w).max()
        err = float(np.abs(g - w).max())
        assert err <= tol, (key, err, tol)
        worst = max(worst, err / tol)
    print(f"{impl}: worst gradient error {worst:.3f} of its bound")


@pytest.mark.parametrize("impl", IMPLS)
def test_trains_with_a_falling_loss(impl, port):
    _, recs = port
    rs = recs[f"train-{impl}"]
    assert [r["seq_axis"] for r in rs] == ["tp"] * 4
    assert [r["batch_rank"] for r in rs] == [[0, 2], [0, 2], [1, 2],
                                             [1, 2]]
    losses = rs[0]["losses"]
    assert all(r["losses"] == losses for r in rs), [r["losses"] for r in rs]
    assert losses[-1] < losses[0] - 0.3, losses
    # Every step's loss and gradient reduction covers dp x tp, and the ring
    # or the all-to-all ran in it.
    kind = "ring_hop" if impl == "ring" else "all_to_all"
    assert all(c[kind]["calls"] > 0 for c in rs[0]["comm"])


# What each disagreement raises (a part of its message).
REFUSED = {
    "no_seq_rule": "tp is not the mesh's sequence axis",
    "seq_mesh_on_plain_job": "without a sequence axis",
    "whole_sequence_on_seq_job": "ran the whole sequence",
    "auto_timed": "runs only on its own job's mesh",
    "auto_cost": "runs only on its own job's mesh",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_cut_that_the_job_does_not_reduce_raises(case, port):
    _, recs = port
    for r in recs["refusals"]:
        assert r[case].get("error") == "ValueError", r[case]
        assert REFUSED[case] in r[case]["msg"], r[case]["msg"]


@pytest.mark.parametrize("case", ["seq_job", "auto_builder"])
def test_a_sequence_parallel_job_gives_the_reference_loss(case, reference,
                                                          port):
    _, recs = port
    rs = [r[case] for r in recs["refusals"]]
    assert all("error" not in r for r in rs), rs
    assert all(r["seq_axis"] == "tp" and r["mesh"] == rs[0]["mesh"]
               for r in rs), rs
    want = float(reference["ring"][0])
    for r in rs:
        assert abs(r["loss"] - want) <= LOSS_RTOL * abs(want), (r, want)
