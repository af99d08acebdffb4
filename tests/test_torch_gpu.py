"""The CUDA k-NN kernels against the plain PyTorch version, and training
through them, on the card.

Marked ``gpu``: each test skips when no CUDA device is found. This file
imports neither JAX nor the JAX package, so that it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.) Tolerance:
``idx`` and offsets bitwise, distances within 1 ulp; a rollout through the
kernels equals the plain path's bitwise, and GNN training on the card is
bitwise repeatable (its gather's backward adds in a fixed order).
"""

import math

import pytest
import torch

from marl_distributedformation_tpu_torch.ops import knn_cuda
from marl_distributedformation_tpu_torch.ops.knn import (
    FUSED_MAX_N,
    knn_batch,
    knn_batch_torch,
    resolve_impl,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_same(got, want):
    gi, go, gd = got
    wi, wo, wd = want
    assert gi.dtype == torch.int32
    assert torch.equal(gi, wi)
    assert torch.equal(go, wo)
    ulp = (gd.view(torch.int32).long() - wd.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 1


def _points(m, n, device, seed=0, kind="random"):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "random":
        pts = torch.rand((m, n, 2), generator=gen, device=device)
        return (pts * torch.tensor([400.0, 600.0], device=device)).contiguous()
    side = math.isqrt(n - 1) + 1
    g = torch.arange(n, device=device)
    lattice = torch.stack([(g % side) * 7.0, (g // side) * 7.0], -1).float()
    if kind == "duplicates":
        lattice[n // 2:] = lattice[: n - n // 2].clone()
    return lattice.expand(m, n, 2).contiguous()


KERNELS = {"knn_fused": knn_cuda.knn_fused, "knn_tiled": knn_cuda.knn_tiled}


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("kind", ["random", "lattice", "duplicates"])
@pytest.mark.parametrize("n,k", [(20, 4), (130, 1), (700, 8), (1030, 5)])
def test_kernel_matches_plain(cuda, name, kind, n, k):
    pts = _points(3, n, cuda, seed=n, kind=kind)
    _assert_same(KERNELS[name](pts, k), knn_batch_torch(pts, k))


# Both sides of every block size of the two designs: a column group (16 in
# knn_fused, 32 in knn_tiled), a warp, a knn_fused CTA (128 rows), a
# knn_tiled CTA (256 rows), a shared-memory tile (1024 columns) and two
# tiles; 640/641 is auto's split.
BLOCK_EDGES = (15, 16, 17, 31, 32, 33, 127, 128, 129, 255, 256, 257, 640,
               641, 1023, 1024, 1025, 2047, 2048, 2049)


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("n", BLOCK_EDGES)
def test_kernel_at_block_edges(cuda, name, n):
    pts = _points(3, n, cuda, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(n)
    valid = torch.rand((3, n), generator=gen, device=cuda) < 0.8
    _assert_same(KERNELS[name](pts, 4), knn_batch_torch(pts, 4))
    _assert_same(KERNELS[name](pts, 4, valid), knn_batch_torch(pts, 4, valid))


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("m", [1, 3, 7])
@pytest.mark.parametrize("n", [20, 100])
def test_kernel_with_few_formations(cuda, name, m, n):
    """M not a multiple of the formations a knn_fused CTA holds."""
    for kind in ("random", "duplicates"):
        pts = _points(m, n, cuda, seed=m, kind=kind)
        _assert_same(KERNELS[name](pts, 4), knn_batch_torch(pts, 4))


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("k", range(1, knn_cuda.MAX_K + 1))
def test_kernel_every_k(cuda, name, k):
    n = 300
    pts = _points(5, n, cuda, seed=k, kind="lattice")
    gen = torch.Generator(device=cuda).manual_seed(k)
    valid = torch.rand((5, n), generator=gen, device=cuda) < 0.5
    valid[0] = False
    valid[0, : k - 1] = True  # fewer than k valid points
    _assert_same(KERNELS[name](pts, k), knn_batch_torch(pts, k))
    _assert_same(KERNELS[name](pts, k, valid), knn_batch_torch(pts, k, valid))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_with_one_valid_point(cuda, name):
    m, n, k = 6, 150, 4
    pts = _points(m, n, cuda, seed=11)
    valid = torch.zeros((m, n), dtype=torch.bool, device=cuda)
    valid[torch.arange(m), torch.arange(m) * 7] = True
    got = KERNELS[name](pts, k, valid)
    _assert_same(got, knn_batch_torch(pts, k, valid))
    rows = torch.arange(n, device=cuda, dtype=torch.int32)
    assert torch.equal(got[0][:, :, 1:], rows[None, :, None].expand(m, n, k - 1))


@pytest.mark.parametrize("name,m,n", [("knn_fused", 4096, 100),
                                      ("knn_tiled", 512, 1024)])
def test_kernel_at_main_shape(cuda, name, m, n):
    pts = _points(m, n, cuda, seed=0)
    _assert_same(KERNELS[name](pts, 4), knn_batch_torch(pts, 4))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_with_short_masks(cuda, name):
    k, n = 4, 600
    pts = _points(8, n, cuda, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    valid = torch.rand((8, n), generator=gen, device=cuda) < 0.3
    valid[0] = False
    valid[0, :2] = True  # two valid points: every row has self-loops
    got = KERNELS[name](pts, k, valid)
    _assert_same(got, knn_batch_torch(pts, k, valid))
    assert torch.equal(
        got[0][0, :, -1], torch.arange(n, device=cuda, dtype=torch.int32)
    )


def test_auto_dispatch_and_launch_counts(cuda):
    knn_cuda.reset_launches()
    small = _points(2, FUSED_MAX_N, cuda)
    big = _points(2, FUSED_MAX_N + 1, cuda)
    assert resolve_impl(small, "auto") == "cuda"
    assert resolve_impl(big, "auto") == "cuda_big"
    _assert_same(knn_batch(small, 4), knn_batch_torch(small, 4))
    _assert_same(knn_batch(big, 4), knn_batch_torch(big, 4))
    assert knn_cuda.LAUNCHES == {"knn_fused": 1, "knn_tiled": 1}
    knn_batch(small, 4, impl="torch")
    assert knn_cuda.LAUNCHES == {"knn_fused": 1, "knn_tiled": 1}


def test_fused_launch_refuses_a_short_span(cuda):
    """The kernel's shared memory holds ``span`` formations; a span below
    what a CTA's rows touch would overrun it and is refused."""
    m, n, k = 4, 100, 4
    pts = _points(m, n, cuda)
    idx = torch.empty((m, n, k), dtype=torch.int32, device=cuda)
    off = torch.empty((m, n, k, 2), device=cuda)
    dist = torch.empty((m, n, k), device=cuda)
    threads, stride, span, _ = knn_cuda.fused_geometry(m, n)
    err = knn_cuda._lib().knn_fused_launch(
        pts.data_ptr(), None, m, n, k, threads, stride, span - 1,
        idx.data_ptr(), off.data_ptr(), dist.data_ptr(),
        torch.cuda.current_stream(cuda).cuda_stream,
    )
    assert err != 0


def test_kernels_refuse_bad_inputs(cuda):
    pts = _points(2, 20, cuda)
    with pytest.raises(ValueError, match="k <= 8"):
        knn_cuda.knn_fused(pts, 9)
    with pytest.raises(TypeError, match="float32"):
        knn_cuda.knn_tiled(pts.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        knn_cuda.knn_fused(pts.transpose(0, 1), 4)
    with pytest.raises(TypeError, match="bool"):
        knn_cuda.knn_tiled(pts, 4, torch.ones(2, 20, device=cuda))


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def _trainer(tmp_path, params, m, model):
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer

    return Trainer(
        params, PPOConfig(n_epochs=2, batch_size=256),
        TrainConfig(num_formations=m, log_dir=str(tmp_path),
                    checkpoint=False),
        model=model, device="cuda",
    )


def _gnn(params):
    from marl_distributedformation_tpu_torch.models import GNNActorCritic

    return GNNActorCritic(k=params.knn_k,
                          generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_training_iteration_on_cuda(cuda, tmp_path, kind):
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.train.trainer import (
        metrics_to_host,
    )

    if kind == "mlp":
        from marl_distributedformation_tpu_torch.models import MLPActorCritic

        params = EnvParams()
        model = MLPActorCritic(params.obs_dim,
                               generator=torch.Generator().manual_seed(0))
    else:
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
        model = _gnn(params)
    trainer = _trainer(tmp_path, params, 16, model)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    metrics = metrics_to_host(trainer.run_iteration())
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    after = list(trainer.model.parameters())
    assert all(torch.isfinite(p).all() for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))
    assert int(trainer.opt_state.count) == trainer.step > 0


@pytest.mark.parametrize("n,name", [(100, "knn_fused"), (700, "knn_tiled")])
def test_training_launch_counts(cuda, tmp_path, n, name):
    from marl_distributedformation_tpu_torch.env import EnvParams

    params = EnvParams(num_agents=n, obs_mode="knn", knn_k=4)
    knn_cuda.reset_launches()
    trainer = _trainer(tmp_path, params, 2, _gnn(params))
    trainer.run_iteration()
    torch.cuda.synchronize()
    other = "knn_tiled" if name == "knn_fused" else "knn_fused"
    # One search at reset, one a rollout step.
    assert knn_cuda.LAUNCHES == {name: 1 + trainer.ppo.n_steps, other: 0}


def test_rollout_kernel_path_equals_plain_path(cuda):
    from marl_distributedformation_tpu_torch.algo import collect_rollout
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        compute_obs,
        reset_batch,
    )

    base = EnvParams(num_agents=100, obs_mode="knn", knn_k=4, max_steps=4)
    model = _gnn(base).to(cuda)
    runs = {}
    for impl in ("auto", "torch"):
        params = base.replace(knn_impl=impl)
        gen = torch.Generator(device=cuda).manual_seed(3)
        state = reset_batch(params, 32, gen, cuda)
        obs = compute_obs(state.agents, state.goal, params)
        runs[impl] = collect_rollout(model, state, obs, gen, params, 10)
    (s1, o1, b1, v1), (s2, o2, b2, v2) = runs["auto"], runs["torch"]
    for field in ("obs", "actions", "log_probs", "values", "rewards",
                  "dones"):
        assert torch.equal(getattr(b1, field), getattr(b2, field)), field
    assert torch.equal(o1, o2) and torch.equal(v1, v2)
    assert torch.equal(s1.agents, s2.agents)
    assert float(b1.dones.sum()) > 0  # resets inside the rollout


# ---------------------------------------------------------------------------
# The iteration captured as CUDA graphs
# ---------------------------------------------------------------------------


def _pair_of_trainers(tmp_path, kind, **cfg):
    """A captured and an eager trainer from one seed (ring/MLP at M=16, or
    the GNN at N=100, M=8)."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer

    if kind == "mlp":
        params, m = EnvParams(), 16
    else:
        params, m = EnvParams(num_agents=100, obs_mode="knn", knn_k=4), 8
    out = {}
    for capture in (True, False):
        gen = torch.Generator().manual_seed(0)
        model = (MLPActorCritic(params.obs_dim, generator=gen)
                 if kind == "mlp" else _gnn(params))
        out[capture] = Trainer(
            params, PPOConfig(n_epochs=2, batch_size=200),
            TrainConfig(num_formations=m, log_dir=str(tmp_path / str(capture)),
                        checkpoint=False, **cfg),
            model=model, device="cuda", capture=capture,
        )
    return out[True], out[False]


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_captured_iteration_equals_eager(cuda, tmp_path, kind):
    """Three iterations (the third fully replayed): parameters, Adam
    state, env carry and metrics bitwise, the MLP's and the GNN's (its
    gather's backward adds in a fixed order, ROADMAP C4). The generator
    state after every iteration equals the eager run's."""
    captured, eager = _pair_of_trainers(tmp_path, kind)
    for i in range(3):
        got = captured.run_iteration()
        want = eager.run_iteration()
        torch.cuda.synchronize()
        assert torch.equal(captured.generator.get_state(),
                           eager.generator.get_state()), i
        for name in ("reward", "avg_dist_to_goal", "episode_dones"):
            assert torch.equal(got[name], want[name]), (i, name)
    assert [g["calls"] for g in captured.graph_stats()] == [
        3, 3 * captured._iteration.num_minibatch_steps, 3]
    assert all(g["nodes"] for g in captured.graph_stats())
    for a, b in zip(captured.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    for moment in ("mu", "nu"):
        for k, v in getattr(captured.opt_state, moment).items():
            assert torch.equal(v, getattr(eager.opt_state, moment)[k])
    assert torch.equal(captured.obs, eager.obs)
    assert torch.equal(captured._iteration.ring.buf,
                       eager._iteration.ring.buf)
    assert captured.step == eager.step


def test_launches_count_by_replay(cuda, tmp_path):
    """The k-NN kernel launches once at reset and once a rollout step, in
    the warm-up, the capture and every replay alike: 1 + 3 x n_steps."""
    captured, _ = _pair_of_trainers(tmp_path, "gnn")
    knn_cuda.reset_launches()
    for _ in range(3):
        captured.run_iteration()
    torch.cuda.synchronize()
    assert knn_cuda.LAUNCHES == {"knn_fused": 3 * captured.ppo.n_steps,
                                 "knn_tiled": 0}
    rollout = captured.graph_stats()[0]
    assert rollout["calls"] == 3 and rollout["capture_s"] is not None


def test_fused_chunk_with_health_on_cuda(cuda, tmp_path):
    """``fused_chunk=2 health=true`` trains four captured iterations with
    finite records, healthy flags and an async checkpoint; a NaN poisoned
    into the parameters after a rollout (inside the chunk) is skipped by
    the guard and leaves the carry finite."""
    captured, _ = _pair_of_trainers(tmp_path, "mlp", fused_chunk=2,
                                    health=True)
    chunk = captured.run_chunk()
    host = chunk.to_host()
    assert host["health_ok"].tolist() == [1.0, 1.0]
    poisoned = []

    def hook(phase):
        if phase == "update" and not poisoned:
            poisoned.append(1)
            captured._poison_carry(float("nan"))

    captured.phase_hook = hook
    host = captured.run_chunk().to_host()
    captured.phase_hook = None
    assert host["health_ok"].tolist() == [0.0, 1.0]
    assert all(bool(torch.isfinite(p).all())
               for p in captured.model.parameters())


def test_rollout_graph_equals_eager_plain_rollout(cuda):
    """A rollout captured through the kernel (``PhaseGraph``: warm-up,
    capture, replay from the generator's state at capture) equals an eager
    rollout through the plain k-NN from the same state, bitwise."""
    from marl_distributedformation_tpu_torch.algo import collect_rollout
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        compute_obs,
        reset_batch,
    )
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    base = EnvParams(num_agents=100, obs_mode="knn", knn_k=4, max_steps=4)
    model = _gnn(base).to(cuda)
    runs = {}
    for impl in ("auto", "torch"):
        params = base.replace(knn_impl=impl)
        gen = torch.Generator(device=cuda).manual_seed(3)
        state = reset_batch(params, 32, gen, cuda)
        obs = compute_obs(state.agents, state.goal, params)
        start = gen.get_state()
        out = []

        def rollout():
            out[:] = collect_rollout(model, state, obs, gen, params, 10)

        if impl == "auto":
            graph = PhaseGraph("rollout", rollout, [gen])
            graph()
            gen.set_state(start)
            graph()
            assert graph.graph is not None and graph.nodes
        else:
            rollout()
        runs[impl] = out
    (_, o1, b1, v1), (_, o2, b2, v2) = runs["auto"], runs["torch"]
    for field in ("obs", "actions", "log_probs", "values", "rewards",
                  "dones"):
        assert torch.equal(getattr(b1, field), getattr(b2, field)), field
    assert torch.equal(o1, o2) and torch.equal(v1, v2)
    assert float(b1.dones.sum()) > 0  # resets inside the captured rollout


# ---------------------------------------------------------------------------
# A population captured as CUDA graphs
# ---------------------------------------------------------------------------


def _pair_of_sweeps(tmp_path, kind, num_seeds=2, **cfg):
    """A captured and an eager population from one seed (ring/MLP at M=16,
    or the GNN at N=100, M=8), members initialised from seeds 0 and 1."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        GNNActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import TrainConfig
    from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer

    if kind == "mlp":
        params, m = EnvParams(), 16
    else:
        params, m = EnvParams(num_agents=100, obs_mode="knn", knn_k=4), 8

    def model(seed):
        gen = torch.Generator().manual_seed(seed)
        if kind == "mlp":
            return MLPActorCritic(params.obs_dim, generator=gen)
        return GNNActorCritic(k=params.knn_k, generator=gen)

    out = {}
    for capture in (True, False):
        out[capture] = SweepTrainer(
            params, PPOConfig(n_epochs=2, batch_size=200),
            TrainConfig(num_formations=m, checkpoint=False,
                        log_dir=str(tmp_path / str(capture)), **cfg),
            num_seeds, models=[model(i) for i in range(num_seeds)],
            device="cuda", capture=capture,
        )
    return out[True], out[False]


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_population_captured_equals_eager(cuda, tmp_path, kind):
    """Three population iterations (the third fully replayed) captured
    against eager: after every iteration the K generators' states equal
    the eager draws'; the stacked parameters, Adam state, env carry and
    metrics bitwise, the MLP's and the GNN's (its gather's backward adds
    in a fixed order, ROADMAP C4)."""
    captured, eager = _pair_of_sweeps(tmp_path, kind)
    for i in range(3):
        got = captured.run_iteration()
        want = eager.run_iteration()
        torch.cuda.synchronize()
        for g, h in zip(captured.generators, eager.generators):
            assert torch.equal(g.get_state(), h.get_state()), i
        for name in ("reward", "avg_dist_to_goal", "episode_dones"):
            assert torch.equal(got[name], want[name]), (i, name)
    assert [g["calls"] for g in captured.graph_stats()] == [
        3, 3 * captured._iteration.num_minibatch_steps, 3]
    for k in captured.model.params:
        assert torch.equal(captured.model.params[k], eager.model.params[k])
    for moment in ("mu", "nu"):
        for k, v in getattr(captured.opt_state, moment).items():
            assert torch.equal(v, getattr(eager.opt_state, moment)[k])
    assert torch.equal(captured.obs, eager.obs)
    assert torch.equal(captured._iteration.ring.buf,
                       eager._iteration.ring.buf)
    assert torch.equal(captured._iteration.step, eager._iteration.step)


def test_population_launches_once_a_step(cuda, tmp_path):
    """One ``knn_fused`` launch a step advances the whole population (its
    K*M formations folded into one batch), in the warm-up, the capture and
    every replay alike: 3 x n_steps over three iterations, not x K."""
    captured, _ = _pair_of_sweeps(tmp_path, "gnn", num_seeds=3)
    knn_cuda.reset_launches()
    for _ in range(3):
        captured.run_iteration()
    torch.cuda.synchronize()
    assert knn_cuda.LAUNCHES == {"knn_fused": 3 * captured.ppo.n_steps,
                                 "knn_tiled": 0}


def test_population_rollout_graph_follows_every_generator(cuda):
    """A population rollout captured with its K generators registered
    (warm-up, capture, replay from the generators' states at capture)
    draws what eager draws from the same states: outputs bitwise, and each
    generator's state after the replay equals its state after the eager
    draws."""
    from marl_distributedformation_tpu_torch.algo import collect_rollout
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        compute_obs,
        reset_batch,
    )
    from marl_distributedformation_tpu_torch.models import GNNActorCritic
    from marl_distributedformation_tpu_torch.models.population import (
        PopulationModel,
    )
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4, max_steps=4)
    pop = PopulationModel([
        GNNActorCritic(k=4, generator=torch.Generator().manual_seed(i))
        for i in range(3)
    ]).to(cuda)
    gens = [torch.Generator(device=cuda).manual_seed(10 + i)
            for i in range(3)]
    state = reset_batch(params, 3 * 8, gens, cuda)
    obs = compute_obs(state.agents, state.goal, params)
    start = [g.get_state() for g in gens]
    out = []

    def rollout():
        out[:] = collect_rollout(pop, state, obs, gens, params, 10,
                                 forward=PopulationModel.rollout_forward)

    graph = PhaseGraph("rollout", rollout, gens)
    graph()  # the warm-up, eager
    for g, s in zip(gens, start):
        g.set_state(s)
    graph()  # captured, then replayed
    torch.cuda.synchronize()
    replayed = [t.clone() for t in (out[2].obs, out[2].actions, out[1])]
    after = [g.get_state() for g in gens]
    for g, s in zip(gens, start):
        g.set_state(s)
    rollout()  # eager, from the same states
    torch.cuda.synchronize()
    for got, want in zip(replayed, (out[2].obs, out[2].actions, out[1])):
        assert torch.equal(got, want)
    for a, g in zip(after, gens):
        assert torch.equal(a, g.get_state())
    assert float(out[2].dones.sum()) > 0  # resets inside the rollout


# ---------------------------------------------------------------------------
# The curriculum over padded formations, captured
# ---------------------------------------------------------------------------


def _hetero_runs(tmp_path, kind, population=False, **cfg):
    """A captured and an eager curriculum run from one seed: ring
    formations padded to N_max=8 over two stages (2 rollouts of 3- and
    5-agent formations, then 1 of 5 and 8 with 2 obstacles), M=8; a
    population of two candidates with ``population``."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        CTDEActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import TrainConfig
    from marl_distributedformation_tpu_torch.train.curriculum import (
        Curriculum,
        CurriculumStage,
        HeteroTrainer,
    )
    from marl_distributedformation_tpu_torch.train.hetero_sweep import (
        HeteroSweepTrainer,
    )

    cur = Curriculum((CurriculumStage(2, (3, 5)),
                      CurriculumStage(1, (5, 8), num_obstacles=2)))
    cls = CTDEActorCritic if kind == "ctde" else MLPActorCritic

    def model(seed):
        return cls(8, generator=torch.Generator().manual_seed(seed))

    out = {}
    for capture in (True, False):
        config = TrainConfig(num_formations=8, checkpoint=False,
                             log_dir=str(tmp_path / str(capture)), **cfg)
        ppo = PPOConfig(n_epochs=2, batch_size=160)
        if population:
            out[capture] = HeteroSweepTrainer(
                cur, EnvParams(), ppo, config, 2,
                models=[model(0), model(1)], device="cuda", capture=capture)
        else:
            out[capture] = HeteroTrainer(cur, EnvParams(), ppo, config,
                                         model=model(0), device="cuda",
                                         capture=capture)
    return out[True], out[False]


def _learner(trainer):
    named = (trainer.model.params.items() if hasattr(trainer.model, "params")
             else trainer.model.named_parameters())
    it = trainer._iteration
    gens = getattr(trainer, "generators", None) or [trainer.generator]
    return {**{k: v.detach() for k, v in named},
            **{f"mu {k}": v for k, v in trainer.opt_state.mu.items()},
            "agents": it.env.agents, "obs": it.obs,
            "n_agents": it.layout.n_agents, "ring": it.ring.buf,
            "gens": torch.stack([g.get_state() for g in gens])}


@pytest.mark.parametrize("kind", ["mlp", "ctde"])
def test_curriculum_captured_equals_eager_across_a_stage(cuda, tmp_path,
                                                         kind):
    """Three iterations with the stage boundary after the second, captured
    against eager: bitwise, the MLP and the CTDE model alike (neither
    reduces with atomics); the same three graphs serve both stages."""
    captured, eager = _hetero_runs(tmp_path, kind)
    captured.train()
    eager.train()
    torch.cuda.synchronize()
    got, want = _learner(captured), _learner(eager)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert captured.graph_count() == 3 and eager.graph_count() == 0
    assert [g["calls"] for g in captured.graph_stats()] == [
        3, 3 * captured._iteration.num_minibatch_steps, 3]


def test_curriculum_graph_count_holds_across_stages(cuda, tmp_path):
    """The stage reset writes counts, state and observation into the
    static carry outside the graphs: after the first stage the run holds
    three graphs, and after the last the same three, not recaptured, and
    the padded agents' values are exactly 0."""
    from marl_distributedformation_tpu_torch.algo.rollout import (
        policy_forward,
    )

    captured, _ = _hetero_runs(tmp_path, "ctde")
    captured.start_stage(captured.curriculum.stages[0])
    for _ in range(2):
        captured.run_iteration()
    first = [id(p.graph) for p in captured._phases]
    count = captured.graph_count()
    captured.start_stage(captured.curriculum.stages[1])
    captured.run_iteration()
    torch.cuda.synchronize()
    assert count == captured.graph_count() == 3
    assert [id(p.graph) for p in captured._phases] == first
    layout = captured.layout
    with torch.no_grad():
        _, _, value = policy_forward(captured.model, captured.obs,
                                     layout.fmask)
    assert bool((value[~layout.mask] == 0).all())
    assert set(layout.n_agents.tolist()) <= {5, 8}


def test_curriculum_population_fused_equals_host_loop(cuda, tmp_path):
    """Two candidates, captured: ``fused_chunk=2`` (chunks 2 | 1, clipped
    at the stage boundary) against the host loop, bitwise."""
    host, _ = _hetero_runs(tmp_path / "host", "mlp", population=True)
    fused, _ = _hetero_runs(tmp_path / "fused", "mlp", population=True,
                            fused_chunk=2)
    host.train()
    fused.train()
    torch.cuda.synchronize()
    got, want = _learner(fused), _learner(host)
    for key in want:
        if key != "ring":  # the ring's rows sit at other slots
            assert torch.equal(got[key], want[key]), key
    assert fused.num_timesteps_members.tolist() == \
        host.num_timesteps_members.tolist()


def _scenario_trainer(tmp_path, schedule, capture=True, **cfg):
    """The ring/MLP at M=16 under a scenario schedule, on the card."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )
    from marl_distributedformation_tpu_torch.train import TrainConfig, Trainer

    params = EnvParams(max_steps=12)
    return Trainer(
        params, PPOConfig(n_epochs=2, batch_size=200),
        TrainConfig(num_formations=16, checkpoint=False,
                    log_dir=str(tmp_path), **cfg),
        model=MLPActorCritic(params.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cuda", capture=capture,
        scenario_schedule=None if schedule is None
        else schedule_from_cfg(schedule),
    )


def test_scenario_severity_zero_is_the_clean_env_on_cuda(cuda):
    """Every registered scenario at severity 0 through the knn step on the
    card (N=100, M=64, ``knn_fused``), 30 steps through a reset: states,
    observations and rewards bitwise the clean run's."""
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        reset_batch,
        step_batch,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        ScenarioStreams,
        init_scenario_state,
        registered_scenarios,
        scenario_params_for,
        scenario_step_batch,
    )

    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4,
                       num_obstacles=4, max_steps=20)
    m = 64
    vel = torch.randn((30, m, 100, 2), device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(1))
    gen = torch.Generator(device=cuda)

    def run(sp):
        gen.manual_seed(0)
        state = reset_batch(params, m, gen, cuda)
        streams = ScenarioStreams(torch.Generator(device=cuda).manual_seed(2))
        if sp is not None:
            state = init_scenario_state(state, params, streams)
        out = []
        for v in vel:
            if sp is None:
                state, tr = step_batch(state, v * 5, params, gen)
            else:
                state, tr = scenario_step_batch(state, v * 5, sp, params,
                                                gen, streams)
            out += [state.agents, state.goal, state.obstacles, tr.obs,
                    tr.reward, tr.done]
        return out

    knn_cuda.reset_launches()
    clean = run(None)
    assert knn_cuda.LAUNCHES["knn_fused"] == 30
    for name in registered_scenarios()[:11]:
        got = run(scenario_params_for(name, 0.0))
        for a, b in zip(clean, got):
            assert torch.equal(a, b), name
        if name != "clean":
            perturbed = run(scenario_params_for(name, 1.0))
            assert not all(torch.equal(a, b)
                           for a, b in zip(clean, perturbed)), name


def test_scenario_graphs_hold_across_a_stage_change(cuda, tmp_path):
    """A stage change and a severity ramp write the scenario buffers
    between replays: the same three graphs serve every stage, and the
    captured run equals the eager one bitwise (MLP)."""
    schedule = ("[{rollouts: 2, scenarios: [clean]}, {rollouts: 2, "
                "scenarios: [wind, sensor_noise, actuator_fault], "
                "severity: 1.0, severity_start: 0.3}]")
    captured = _scenario_trainer(tmp_path / "c", schedule)
    eager = _scenario_trainer(tmp_path / "e", schedule, capture=False)
    for _ in range(2):
        captured.run_iteration()
        eager.run_iteration()
    first = [id(p.graph) for p in captured._phases]
    assert captured.graph_count() == 3
    for _ in range(2):
        captured.run_iteration()
        eager.run_iteration()
    torch.cuda.synchronize()
    assert captured.graph_count() == 3
    assert [id(p.graph) for p in captured._phases] == first
    for a, b in zip(captured.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(captured.obs, eager.obs)
    assert torch.equal(captured.scenario_generator.get_state(),
                       eager.scenario_generator.get_state())
    assert torch.equal(captured.scenario_params.wind,
                       eager.scenario_params.wind)


def _gnn100(seed=0):
    from marl_distributedformation_tpu_torch.models import GNNActorCritic

    gen = torch.Generator().manual_seed(seed)
    return GNNActorCritic(k=4, generator=gen)


MATRIX_CELLS = (("clean", 0.0), ("wind", 0.5), ("storm", 1.0),
                ("comm_dropout", 1.0), ("sensor_noise", 0.0))


def test_matrix_captured_equals_eager(cuda):
    """The robustness matrix's step captured as one CUDA graph against the
    same program run eagerly, cell by cell (N=100, M=16, ``knn_fused``):
    every metric bitwise; one build each across the cells and two
    parameter sets; the clean cell bitwise ``eval.run_episode_metrics``;
    ``knn_fused`` launches episode_length + 1 a cell, by replay."""
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        episode_length,
        policy_act_fn,
        run_episode_metrics,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        MatrixProgram,
        scenario_params_for,
    )

    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4,
                       max_steps=30)
    models = [_gnn100(0).to(cuda), _gnn100(1).to(cuda)]
    runs = {}
    for capture in (True, False):
        prog = MatrixProgram(models[0], params, num_formations=16,
                             device=cuda, capture=capture)
        knn_cuda.reset_launches()
        runs[capture] = [prog.run(m.state_dict(),
                                  scenario_params_for(name, sev))
                         for m in models for name, sev in MATRIX_CELLS]
        torch.cuda.synchronize()
        assert prog.compile_count == 1
        assert knn_cuda.LAUNCHES["knn_fused"] == (
            len(runs[capture]) * (episode_length(params) + 1))
    for got, want in zip(runs[True], runs[False]):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    raw = run_episode_metrics(policy_act_fn(models[0], params), params, 16,
                              device=cuda)
    for key in raw:
        assert torch.equal(runs[True][0][key], raw[key]), key


def test_population_fold_through_knn_fused(cuda):
    """The falsifier search's population folded into the formation batch
    (P=13 candidates x M=8 formations, N=100) through ``knn_fused``: every
    severity-0 row bitwise the clean row; captured == eager bitwise; a
    disturbed row within rtol 1e-5 of the matrix cell (batched GEMMs of
    P x M rows may round differently from M-row ones)."""
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.scenarios import (
        get_scenario,
        make_matrix_runner,
        make_population_runner,
        registered_scenarios,
    )
    from marl_distributedformation_tpu_torch.scenarios.adversary import (
        _stack_rows,
    )

    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4,
                       max_steps=30)
    model = _gnn100().to(cuda)
    rows = ([(get_scenario("clean"), 0.0)]
            + [(get_scenario(n), 0.0) for n in registered_scenarios()]
            + [(get_scenario("wind"), 0.7)])
    outs = {}
    for capture in (True, False):
        run, guard = make_population_runner(model, params, 8, device=cuda,
                                            capture=capture)
        knn_cuda.reset_launches()
        outs[capture] = run(model.state_dict(), _stack_rows(rows))
        torch.cuda.synchronize()
        assert guard.count == 1
        assert knn_cuda.LAUNCHES == {"knn_fused": 33, "knn_tiled": 0}
    for key, values in outs[True].items():
        assert torch.equal(values, outs[False][key]), key
        for i in range(1, len(rows) - 1):
            assert torch.equal(values[i], values[0]), (key, rows[i][0].name)
    cell, _ = make_matrix_runner(model, params, 8, device=cuda)
    want = cell(model.state_dict(), get_scenario("wind").build(0.7))
    for key, value in want.items():
        torch.testing.assert_close(outs[True][key][-1], value, rtol=1e-5,
                                   atol=1e-5)


def test_pursuit_kernel_path_equals_plain_path(cuda):
    """Pursuit-evasion on k-NN observations (N=100, M=64, 30 steps through
    a reset): ``knn_fused`` against the plain k-NN, every metric bitwise;
    the pursuer's nearest evader is the first of equal distances."""
    from marl_distributedformation_tpu_torch.envs import PursuitParams
    from marl_distributedformation_tpu_torch.envs.pursuit import (
        nearest_index,
    )
    from marl_distributedformation_tpu_torch.eval import (
        evaluate,
        policy_act_fn,
    )

    model = _gnn100().to(cuda)
    runs = {}
    for impl in ("auto", "torch"):
        params = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4,
                               max_steps=28, knn_impl=impl)
        knn_cuda.reset_launches()
        runs[impl] = evaluate(policy_act_fn(model, params), params, 64,
                              seed=5, device=cuda)
        assert knn_cuda.LAUNCHES["knn_fused"] == (31 if impl == "auto"
                                                  else 0)
    assert runs["auto"] == runs["torch"]
    dists = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.5, 0.5, 0.5, 0.5],
                          [2.0, float("nan"), 0.1, float("nan")]],
                         device=cuda).repeat(1000, 1)
    want = torch.tensor([1, 0, 1], device=cuda).repeat(1000)
    assert torch.equal(nearest_index(dists), want)


# -- serving: one CUDA graph a rung -------------------------------------------


def _serving_policy(cuda, kind):
    """A seeded policy on the card and rows for it: the MLP on flat rows,
    the GNN on whole formations of k-NN rows with valid indices."""
    import numpy as np

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.models import (
        GNNActorCritic,
        MLPActorCritic,
    )

    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    if kind == "mlp":
        model = MLPActorCritic(8, generator=gen)
        rows = rng.standard_normal((1100, 8)).astype(np.float32)
    else:
        n, k = 20, 4
        model = GNNActorCritic(k=k, generator=gen)
        feats = rng.standard_normal((1100, n, 4 + 3 * k)).astype(np.float32)
        idx = np.stack([rng.permutation(n)[:k] for _ in range(1100 * n)])
        rows = np.concatenate(
            [feats, idx.reshape(1100, n, k).astype(np.float32)], -1)
    return LoadedPolicy(model.to(cuda).eval(), num_agents=None), rows


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_serving_captured_rung_equals_eager(cuda, kind):
    """Each rung captured as a CUDA graph equals the same rung run eagerly,
    bitwise, on the split path too; one capture a rung."""
    import numpy as np

    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )

    policy, rows = _serving_policy(cuda, kind)
    captured = BucketedPolicyEngine(policy, buckets=(1, 8, 64, 512))
    eager = BucketedPolicyEngine(policy, buckets=(1, 8, 64, 512),
                                 capture=False)
    for n in (1, 5, 8, 64, 300, 512, 1100):
        got = captured.act(rows[:n])
        assert np.array_equal(got, eager.act(rows[:n])), n
        np.testing.assert_allclose(got, policy.predict(rows[:n])[0],
                                   rtol=1e-5, atol=1e-6)
    want = {1: 1, 8: 1, 64: 1, 512: 1}
    assert captured.compile_counts() == eager.compile_counts() == want
    assert all(captured.rung(b).graph.graph is not None for b in want)
    assert all(eager.rung(b).graph.graph is None for b in want)


def test_serving_swap_never_recaptures(cuda, tmp_path):
    """A hot swap through the registry copies the new weights into the
    captured parameter tensors at the batch barrier: the same graphs, one
    capture a rung, results pinned to the step that computed them."""
    import numpy as np

    from marl_distributedformation_tpu_torch.compat.convert import (
        params_to_jax,
    )
    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
        MicroBatchScheduler,
        ModelRegistry,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        save_checkpoint,
    )

    def write(step, seed):
        model = MLPActorCritic(8, generator=torch.Generator().manual_seed(seed))
        save_checkpoint(tmp_path, step, {
            "policy": "MLPActorCritic",
            "params": params_to_jax(model.state_dict(), "MLPActorCritic"),
            "num_timesteps": step})
        return LoadedPolicy(model.to(cuda))

    pol_a = write(10, 0)
    registry = ModelRegistry(tmp_path, device="cuda")
    assert all(t.is_cuda for t in registry.active()[0].values())
    engine = BucketedPolicyEngine(registry.policy, buckets=(1, 8, 64))
    rows = np.random.default_rng(1).standard_normal((70, 8)).astype(
        np.float32)
    with MicroBatchScheduler(engine, registry=registry) as sched:
        # One at a time, so that each builds its own rung.
        first = [sched.submit(rows[:n]).result(timeout=60)
                 for n in (1, 8, 70)]
        graphs = {b: engine.rung(b).graph.graph for b in (1, 8, 64)}
        pol_b = write(20, 1)
        assert registry.refresh()
        after = [sched.submit(rows[:n]).result(timeout=60)
                 for n in (1, 8, 70)]
    for res, n in zip(first, (1, 8, 70)):
        assert res.model_step == 10
        np.testing.assert_allclose(res.actions, pol_a.predict(rows[:n])[0],
                                   rtol=1e-5, atol=1e-6)
    for res, n in zip(after, (1, 8, 70)):
        assert res.model_step == 20
        np.testing.assert_allclose(res.actions, pol_b.predict(rows[:n])[0],
                                   rtol=1e-5, atol=1e-6)
    assert engine.compile_counts() == {1: 1, 8: 1, 64: 1}
    assert all(engine.rung(b).graph.graph is g for b, g in graphs.items())


def test_serving_bf16_within_budget_and_fresh_draws(cuda):
    """The bf16 ladder of a seeded tanh-MLP within ``tests/bf16_budget.py``'s
    budget, with cuBLAS's reduced-precision bf16 reductions off; every
    replay of a rung draws fresh noise."""
    import numpy as np
    from bf16_budget import bf16_action_atol

    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )

    resolve_device("cuda")
    assert not (
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    policy, rows = _serving_policy(cuda, "mlp")
    f32 = BucketedPolicyEngine(policy, buckets=(1, 8, 64, 512))
    bf16 = BucketedPolicyEngine(policy, buckets=(1, 8, 64, 512),
                                dtype="bfloat16")
    for n in (1, 8, 64, 512):
        np.testing.assert_allclose(bf16.act(rows[:n]), f32.act(rows[:n]),
                                   rtol=0, atol=bf16_action_atol(3))
    draws = [f32.act(rows[:64], deterministic=False) for _ in range(3)]
    assert not np.array_equal(draws[0], draws[1])
    assert not np.array_equal(draws[1], draws[2])


# ---------------------------------------------------------------------------
# C4, Sebulba and the ledger on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(512, 100), (16, 1024)])
def test_deterministic_gather_is_bitwise_repeatable(cuda, m, n):
    """The GNN gather's backward (the one-hot GEMM at N=100, the sorted
    segment sum at N=1024) gives the same bits every run, where
    ``torch.gather``'s atomic ``scatter_add`` need not; and it equals that
    within f32 rounding."""
    from marl_distributedformation_tpu_torch.models.gnn import gather_nodes

    gen = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((m, n, 64), device=cuda, generator=gen)
    # Hub-heavy indices: many contributions into a few rows.
    idx = torch.randint(0, 5, (m, n, 4), device=cuda, generator=gen)
    w = torch.randn((m, n, 4, 64), device=cuda, generator=gen)
    grads = []
    for _ in range(3):
        x = h.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((gather_nodes(x, idx) * w).sum(), x)
        grads.append(g)
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[1],
                                                           grads[2])
    # Against the exact sums (float64), within the recursive-summation
    # bound terms * 2**-24 * sum|terms| of each row.
    flat = idx.reshape(m, 4 * n, 1).expand(m, 4 * n, 64)

    def scatter(values):
        return torch.zeros((m, n, 64), dtype=torch.float64,
                           device=cuda).scatter_add_(
            -2, flat, values.double().reshape(m, 4 * n, 64))

    exact = scatter(w)
    bound = scatter(torch.ones_like(w)) * 2.0 ** -24 * scatter(w.abs())
    assert bool(((grads[0].double() - exact).abs() <= bound).all())


def test_deterministic_gather_replays_in_a_graph(cuda):
    """The backward captures (no host sync) and its replay equals the
    eager gradient bitwise."""
    from marl_distributedformation_tpu_torch.models.gnn import gather_nodes

    gen = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn((64, 100, 64), device=cuda, generator=gen,
                    requires_grad=True)
    idx = torch.randint(0, 100, (64, 100, 4), device=cuda, generator=gen)
    out = torch.empty_like(h)

    def step():
        (g,) = torch.autograd.grad(gather_nodes(h, idx).pow(2).sum(), h)
        out.copy_(g)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    eager = out.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _sebulba_pair(tmp_path, kind):
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.train import (
        SebulbaDriver,
        TrainConfig,
        Trainer,
    )

    if kind == "mlp":
        params, m = EnvParams(), 16
    else:
        params, m = EnvParams(num_agents=100, obs_mode="knn", knn_k=4), 8
    out = []
    for cls, arch in ((Trainer, "anakin"), (SebulbaDriver, "sebulba")):
        gen = torch.Generator().manual_seed(0)
        model = (MLPActorCritic(params.obs_dim, generator=gen)
                 if kind == "mlp" else _gnn(params))
        out.append(cls(
            params, PPOConfig(n_epochs=2, batch_size=200),
            TrainConfig(num_formations=m, log_dir=str(tmp_path / arch),
                        checkpoint=False, architecture=arch),
            model=model, device="cuda"))
    return out


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_sebulba_lockstep_equals_anakin_on_the_card(cuda, tmp_path, kind):
    """Three lockstep round trips (the actor's rollout and the learner's
    update each on its own stream, both captured by the second) against
    the captured Anakin host loop: parameters and metrics bitwise."""
    anakin, sebulba = _sebulba_pair(tmp_path, kind)
    for i in range(3):
        a = anakin.run_iteration()
        s = sebulba.run_lockstep_iteration()
        torch.cuda.synchronize()
        for name in a:
            assert torch.equal(a[name], s[name]), (i, name)
    for p, q in zip(anakin.model.parameters(), sebulba.model.parameters()):
        assert torch.equal(p, q)
    assert sebulba.graph_count() == 3 and anakin.graph_count() == 3
    assert sebulba.actor_guard.count == sebulba.learner_guard.count == 1


def test_census_from_a_captured_phase(cuda, tmp_path):
    """A captured phase registers once, with its capture seconds and graph
    nodes as ``graph_stats()`` reports them, and its replays as
    dispatches."""
    from marl_distributedformation_tpu_torch.obs import (
        ProgramLedger,
        load_census,
        set_ledger,
    )
    from marl_distributedformation_tpu_torch.train.capture import PhaseGraph

    previous = set_ledger(ProgramLedger())
    try:
        x = torch.randn((256, 256), device=cuda)
        y = torch.empty_like(x)
        phase = PhaseGraph("mm", lambda: torch.mm(x, x, out=y),
                           subsystem="test", program="mm")
        for _ in range(4):
            phase()
        from marl_distributedformation_tpu_torch.obs.ledger import (
            get_ledger,
        )

        path = get_ledger().write_census(tmp_path / "program_ledger.json")
    finally:
        set_ledger(previous)
    (rec,) = load_census(path)["programs"]
    stats = phase.stats()
    assert rec["key"] == "test_mm" and rec["backend"] == "cuda"
    assert rec["graph_nodes"] == stats["nodes"] >= 1
    assert rec["compile_seconds"] == stats["capture_s"] > 0
    assert rec["first_dispatch_seconds"] > 0
    assert rec["flops"] == 2 * 256 ** 3
    # Calls 3 and 4; the capturing call is the build, not a dispatch.
    assert rec["dispatches_total"] == 2.0


@pytest.mark.parametrize("obs_mode", ["ring", "knn"])
def test_single_formation_step_is_its_step_batch_row(cuda, obs_mode):
    """One formation's ``step`` on the card equals row 0 of ``step_batch``
    at M=1 from one generator seed, across an auto-reset: state, reward,
    done, metrics and observation bitwise. A formation's k-NN observation
    is its batch of one's (``knn_fused`` at ``(1, N, k)``, one launch a
    step)."""
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        reset,
        reset_batch,
        step,
        step_batch,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    params = EnvParams(num_agents=100 if obs_mode == "knn" else 5,
                       obs_mode=obs_mode, knn_k=4, max_steps=6)
    g1 = torch.Generator(device=cuda).manual_seed(4)
    g2 = torch.Generator(device=cuda).manual_seed(4)
    one, batch = reset(params, g1, cuda), reset_batch(params, 1, g2, cuda)
    vel_gen = torch.Generator(device=cuda).manual_seed(5)
    dones = 0
    for _ in range(12):
        vel = torch.randn((1, params.num_agents, 2), generator=vel_gen,
                          device=cuda) * 8
        knn_cuda.reset_launches()
        one, t1 = step(one, vel[0], params, g1)
        want = 1 if obs_mode == "knn" else 0
        assert knn_cuda.LAUNCHES == {"knn_fused": want, "knn_tiled": 0}
        batch, tb = step_batch(batch, vel, params, g2)
        for f in ("agents", "goal", "obstacles", "steps"):
            assert torch.equal(getattr(one, f), getattr(batch, f)[0]), f
        for f in ("obs", "reward", "done"):
            assert torch.equal(getattr(t1, f), getattr(tb, f)[0]), f
        for k, v in tb.metrics.items():
            assert torch.equal(t1.metrics[k], v[0]), k
        dones += int(t1.done)
    assert dones == 1


# ---------------------------------------------------------------------------
# The fleet and the runtime guards on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlp", "gnn"])
def test_fleet_of_two_on_one_card_equals_one_engine(cuda, kind):
    """Two replicas on ``cuda:0``, each with its own engine, stream and
    copy of the parameters: every rung of every replica captured before
    traffic, once; each replica's deterministic actions equal a single
    engine's bitwise, served through the router too."""
    import numpy as np

    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetRouter,
        warmup_fleet,
    )

    policy, rows = _serving_policy(cuda, kind)
    buckets = (1, 8, 64, 512)
    engine = BucketedPolicyEngine(policy, buckets=buckets)
    router = FleetRouter(policy, num_replicas=2, buckets=buckets)
    assert [r.device for r in router.replicas] == [torch.device("cuda", 0)] * 2
    warmup_fleet(router, rows.shape[1:])
    assert router.compile_counts() == {0: dict.fromkeys(buckets, 1),
                                       1: dict.fromkeys(buckets, 1)}
    for r in router.replicas:
        params, _ = r.registry.active()
        for n in (1, 5, 64, 512, 1100):
            assert np.array_equal(r.engine.act(rows[:n], nn_params=params),
                                  engine.act(rows[:n])), (r.index, n)
    with router:
        # One at a time: a request coalesced with another runs through a
        # larger rung, whose GEMM tiles can round its rows apart.
        for n in (3, 64, 300, 9):
            got = router.submit(rows[:n]).result(timeout=60).actions
            assert np.array_equal(got, engine.act(rows[:n])), n
    assert router.compile_counts() == {0: dict.fromkeys(buckets, 1),
                                       1: dict.fromkeys(buckets, 1)}


def test_guard_transfers_raises_on_an_item_in_a_guarded_dispatch(
        cuda, tmp_path):
    """With ``guard_transfers`` the post-warm-up dispatches run under the
    CUDA sync debug mode: a clean one passes, an ``.item()`` inside one
    raises, and the mode is restored after."""
    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )

    params = EnvParams(num_agents=3)
    trainer = Trainer(
        params, PPOConfig(n_steps=4, batch_size=24, n_epochs=2),
        TrainConfig(num_formations=4, log_dir=str(tmp_path),
                    checkpoint=False, guard_transfers=True,
                    guard_retraces=1),
        model=MLPActorCritic(params.obs_dim,
                             generator=torch.Generator().manual_seed(0)),
        device="cuda")
    for _ in range(3):  # warm-up, capture, the first guarded dispatch
        trainer.run_iteration()
    trainer.phase_hook = lambda phase: torch.ones((), device="cuda").item()
    with pytest.raises(RuntimeError, match="synchroniz"):
        trainer.run_iteration()
    trainer.phase_hook = None
    assert torch.cuda.get_sync_debug_mode() == 0
    trainer.run_iteration()
    assert trainer.retrace_guard.count == 1
