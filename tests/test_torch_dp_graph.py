"""The port's data-parallel step as a captured CUDA graph: an NCCL rank's
compiled train and eval steps replay graphs that hold the step's
collectives (BatchNorm's sums over the ranks, the gradient all-reduce, the
mean of the loss terms), the JAX package's `jax.jit` of the step over a mesh
(stabnet_tpu/train/train.py:185-207); a gloo rank and the CPU stay eager.

On the CPU, at TINY with the narrow trunk of tests/test_torch_train.py, in
f32, over five steps that cross every loss gate and the learning rate's
staircase (tests/test_torch_train_graph.py's schedule), global batch 4:
  * the graph decision, `_compiled`, on {cpu, cuda} x {no group, nccl,
    gloo};
  * two gloo ranks (torch.multiprocessing.spawn, a FileStore: no TCP port)
    through the compiled path, forced by a stand-in for the graph cache
    (`GraphLike` of tests/test_torch_compiled_eval.py: the function eagerly
    at the first call, then its results written into the held outputs, as
    a replay writes its buffers), each beside its own eager `train_step`
    in lockstep: every loss term, parameter, BN statistic, Adam moment and
    both counters bit for bit at every step, and the eval step's terms
    bit for bit `eval_step`'s; both ranks return the same global terms;
    the spawned ranks import no JAX;
  * the same ranks from Flax variables converted with
    `convert_flax_variables`, against the JAX package's
    `make_train_step(model, cfg, mesh=data_mesh(jax.devices()[:2]))` on
    the global batch, each step from the ranks' state before it: loss
    terms within 1e-5 relative, BN statistics within 1e-6 absolute
    (tests/test_torch_train.py's bounds).

The `cuda` tests run one NCCL rank (a world of one) in a spawned process
on the card, on BatchNorm's own branch and with its across-ranks branch
forced (the rank's `resnet._ranks` patched to 2, so its all-reduces run
and are captured): the graph `torch.equal` to the eager step over the same
five steps, and the eval graph to `eval_step`.  They skip without a card.
On a machine with a card and no JAX:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dp_graph.py
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stabnet_tpu_torch.config import get_config
from stabnet_tpu_torch.models import make_model, resnet, scale_theta_head
from stabnet_tpu_torch.models.resnet import StabNetRegressor
from stabnet_tpu_torch.train import (Adam, TrainState, eval_step, make_eval_step,
                                     make_train_step, train_step)
from stabnet_tpu_torch.train import train as train_mod
from tests.test_torch_train_graph import GATES, _batch

STEPS = 5            # through every gate (1, 2, 3) and the staircase at 4
GLOBAL_BATCH = 4
TIMEOUT = 300        # seconds for one group of spawned ranks


# --- the graph decision --------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "nccl", "gloo"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_graph_decision(monkeypatch, device, backend):
    """Graphs on a CUDA state alone or as an NCCL rank; eager under gloo
    (its all-reduce of CUDA tensors goes through the host) and on the
    CPU."""
    monkeypatch.setattr(train_mod, "group_backend", lambda: backend)
    state = types.SimpleNamespace(device=torch.device(device, 0) if device == "cuda"
                                  else torch.device(device))
    assert train_mod._compiled(state) == (device == "cuda" and backend != "gloo")


# --- ranks in spawned processes ------------------------------------------------

def _state_equal(a: TrainState, b: TrainState) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(a.opt.mu + a.opt.nu,
                                                      b.opt.mu + b.opt.nu))
            and (a.step, int(a.step_t), a.opt.count, int(a.opt.count_t))
            == (b.step, int(b.step_t), b.opt.count, int(b.opt.count_t)))


def _rank_main(rank: int, world: int, backend: str, tmp: str, device: str,
               across: bool) -> None:
    """One rank: the compiled steps beside the eager ones from the same
    state, in lockstep on the rank's slice of each global batch; writes
    `rank<r>.pt` (per step both runs' loss terms and whether the states
    are equal, the eval terms, the graph cache's stats, whether JAX was
    imported, and on rank 0 the state before each step).  On the CPU the
    compiled path is forced through `GraphLike`; on a card it is the real
    one.  `across` forces BatchNorm's across-ranks branch."""
    torch.set_num_threads(1)
    dev = torch.device(device, rank) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cudnn.deterministic = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    compiled, ranks = train_mod._compiled, resnet._ranks
    try:
        setup = torch.load(os.path.join(tmp, "setup.pt"), weights_only=True)
        cfg = get_config("tiny").replace(**setup["cfg"])
        n = cfg.batch_size // world
        batches = [{k: v[rank * n:(rank + 1) * n].to(dev) for k, v in b.items()}
                   for b in setup["batches"]]

        def fresh():
            model = StabNetRegressor(cfg.in_channels, cfg.theta_dim, dtype=torch.float32,
                                     **setup["narrow"])
            model.load_state_dict(setup["model"])
            model = model.to(dev).train()
            return TrainState(step=0, model=model, opt=Adam(model.parameters()))

        graph_state, eager_state = fresh(), fresh()
        if dev.type == "cpu":
            from tests.test_torch_compiled_eval import GraphLike

            graph_state.graphs = GraphLike()
            train_mod._compiled = lambda state: True
        if across:
            resnet._ranks = lambda: 2
        step, evaluate = make_train_step(cfg), make_eval_step(cfg)
        out = {"graph": [], "eager": [], "equal": [], "before": []}
        for b in batches:
            if rank == 0:
                out["before"].append({k: v.detach().cpu().clone() for k, v in
                                      graph_state.model.state_dict().items()})
            graph_state, g = step(graph_state, b)
            eager_state, e = train_step(eager_state, b, cfg)
            out["graph"].append({k: v.cpu() for k, v in g.items()})
            out["eager"].append({k: v.cpu() for k, v in e.items()})
            out["equal"].append(_state_equal(graph_state, eager_state))
        out["eval_graph"] = {k: v.cpu() for k, v in evaluate(graph_state, batches[0]).items()}
        out["eval_eager"] = {k: v.cpu() for k, v in
                             eval_step(eager_state, batches[0], cfg).items()}
        out["stats"] = ({k: v.cpu() for k, v in graph_state.model.state_dict().items()
                         if "running" in k})
        out["graphs"] = ([(g["key"][0], g["replays"]) for g in graph_state.graphs.stats()]
                         if dev.type == "cuda" else [])
        out["jax"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        train_mod._compiled, resnet._ranks = compiled, ranks
        dist.destroy_process_group()


def _spawn(world: int, backend: str, tmp: str, device: str, across: bool = False):
    """`_rank_main` in `world` spawned processes; each is killed at the
    timeout (a rank waiting at a collective for a failed peer would hang)."""
    ctx = torch.multiprocessing.spawn(_rank_main, args=(world, backend, tmp, device, across),
                                      nprocs=world, join=False)
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, f"ranks did not finish in {TIMEOUT} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


OVERRIDES = dict(GATES, batch_size=GLOBAL_BATCH)
CFG = get_config("tiny").replace(**OVERRIDES)


def _setup(tmp: str, model: StabNetRegressor, narrow: dict) -> dict:
    """The run's configuration, the global batches and the weights of
    `model` (built with the widths `narrow`), for the spawned ranks."""
    setup = {"cfg": OVERRIDES, "narrow": narrow, "model": model.state_dict(),
             "batches": [_batch(CFG, seed) for seed in range(STEPS)]}
    torch.save(setup, os.path.join(tmp, "setup.pt"))
    return setup


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Two gloo ranks from the converted Flax weights of
    tests/test_torch_train_graph.py's narrow state."""
    from tests.test_torch_train import NARROW
    from tests.test_torch_train_graph import _narrow_state

    tmp = str(tmp_path_factory.mktemp("dp_graph"))
    setup = _setup(tmp, _narrow_state(CFG).model, NARROW)
    return setup, _spawn(2, "gloo", tmp, "cpu")


def _terms(aux) -> dict:
    return {k: float(v) for k, v in aux.items()}


@pytest.mark.parametrize("rank", [0, 1])
def test_compiled_rank_equals_its_eager_steps(gloo_ranks, rank):
    out = gloo_ranks[1][rank]
    assert out["equal"] == [True] * STEPS
    for g, e in zip(out["graph"], out["eager"]):
        assert set(g) == set(e) == set(train_mod.AUX_KEYS)
        assert all(torch.equal(g[k], e[k]) for k in e)
    # Every gate and the staircase were crossed.
    assert float(out["graph"][0]["temp"]) == 0.0 and float(out["graph"][-1]["temp"]) > 0.0


def test_compiled_eval_step_equals_eval_step(gloo_ranks):
    for out in gloo_ranks[1]:
        assert all(torch.equal(out["eval_graph"][k], out["eval_eager"][k])
                   for k in out["eval_eager"])
    assert _terms(gloo_ranks[1][0]["eval_graph"]) == _terms(gloo_ranks[1][1]["eval_graph"])


def test_ranks_return_the_global_terms(gloo_ranks):
    """Both ranks' compiled steps return the same terms (the global batch's),
    and their BN statistics agree (the global batch's too)."""
    r0, r1 = gloo_ranks[1]
    assert [_terms(a) for a in r0["graph"]] == [_terms(a) for a in r1["graph"]]
    assert all(torch.equal(r0["stats"][k], r1["stats"][k]) for k in r0["stats"])


def test_spawned_ranks_import_no_jax(gloo_ranks):
    assert [out["jax"] for out in gloo_ranks[1]] == [False, False]


def test_ranks_match_the_jax_mesh_step(gloo_ranks):
    """Each step of the ranks' compiled run against the JAX package's step
    over a 2-device mesh on the global batch, from the ranks' state before
    it (weights and statistics; the loss and the new statistics do not
    read Adam's moments): loss terms within 1e-5 relative, BN statistics
    within 1e-6 absolute."""
    import jax
    import jax.numpy as jnp

    from stabnet_tpu.config import get_config as jax_config
    from stabnet_tpu.parallel import data_mesh
    from stabnet_tpu.train.state import TrainState as JaxState
    from stabnet_tpu.train.state import make_optimizer, replicate_state
    from stabnet_tpu.train.train import make_train_step as jax_make_train_step
    from stabnet_tpu_torch.models import convert_flax_variables
    from tests.test_torch_train import _JaxNarrow
    from tests.test_torch_train_graph import _narrow_weights, _to_flax

    setup, (r0, _) = gloo_ranks
    cfg = jax_config("tiny").replace(**OVERRIDES)
    mesh = data_mesh(jax.devices()[:2])
    step = jax_make_train_step(_JaxNarrow(cfg.theta_dim), cfg, mesh=mesh)
    tx = make_optimizer(cfg)
    after = r0["before"][1:] + [None]
    loss_gap = stats_gap = 0.0
    for i, (batch, before) in enumerate(zip(setup["batches"], r0["before"])):
        v = _to_flax(_narrow_weights(), before)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        state = replicate_state(JaxState(step=jnp.asarray(i, jnp.int32), params=params,
                                         batch_stats=v["batch_stats"],
                                         opt_state=tx.init(params)), mesh)
        new, aux = step(state, {k: t.numpy() for k, t in batch.items()})
        got = r0["graph"][i]
        assert set(got) == set(aux)
        for k, want in aux.items():
            want = float(want)
            loss_gap = max(loss_gap, abs(float(got[k]) - want) / max(abs(want), 1e-30))
            np.testing.assert_allclose(float(got[k]), want, rtol=1e-5, atol=0,
                                       err_msg=f"step {i} {k}")
        mine = after[i] if after[i] is not None else r0["stats"]
        stats = jax.tree_util.tree_map(np.asarray, new.batch_stats)
        for name, ref in convert_flax_variables({"batch_stats": stats}).items():
            stats_gap = max(stats_gap, float((mine[name] - ref).abs().max()))
            np.testing.assert_allclose(mine[name].numpy(), ref.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {name}")
    print(f"largest gaps to the JAX mesh step: loss terms {loss_gap:.3g} relative, "
          f"BN statistics {stats_gap:.3g}")


# --- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("across", [False, True], ids=["own_branch", "across_ranks"])
def test_card_nccl_rank_graph_equals_the_eager_step(card, tmp_path, across):
    """One NCCL rank: the train graph `torch.equal` to the eager step at
    every step (loss terms, parameters, statistics, moments, counters), the
    eval graph to `eval_step`; one train graph replayed STEPS - 1 times and
    one eval graph."""
    model = scale_theta_head(make_model(CFG, torch.Generator().manual_seed(0)), 0.05)
    _setup(str(tmp_path), model, {})
    (out,) = _spawn(1, "nccl", str(tmp_path), "cuda", across)
    assert out["equal"] == [True] * STEPS
    for g, e in zip(out["graph"], out["eager"]):
        assert all(torch.equal(g[k], e[k]) for k in e)
    assert all(torch.equal(out["eval_graph"][k], out["eval_eager"][k])
               for k in out["eval_eager"])
    assert out["graphs"] == [("train_step", STEPS - 1), ("eval_step", 0)]
