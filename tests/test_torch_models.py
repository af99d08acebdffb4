"""The port's models, parameter conversion and checkpoint reader against the
JAX package on the CPU.

Tolerances: ``(mean, log_std, value)`` within ``atol=1e-5`` plus
``rtol=1e-6`` (PyTorch and XLA sum the matmuls in different orders; the
relative term is for the trained critic's values near 580, where one float32
step is 6e-5); the checkpoint tree exact.
"""

import struct
import zlib
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.compat.policy import (
    LoadedPolicy as JaxLoadedPolicy,
    load_checkpoint_raw,
)
from marl_distributedformation_tpu.models import (
    GNNActorCritic as JaxGNN,
    MLPActorCritic as JaxMLP,
    distributions as jax_distributions,
)
from marl_distributedformation_tpu.models.gnn import (
    gather_nodes as jax_gather_nodes,
    parse_knn_obs as jax_parse_knn_obs,
)
from marl_distributedformation_tpu_torch.compat.convert import params_from_jax
from marl_distributedformation_tpu_torch.compat.policy import (
    LoadedPolicy,
    build_model,
    infer_hidden,
)
from marl_distributedformation_tpu_torch.models import (
    GNNActorCritic,
    MLPActorCritic,
    distributions,
)
from marl_distributedformation_tpu_torch.models.gnn import (
    ONE_HOT_MAX_N,
    gather_nodes,
    parse_knn_obs,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    checkpoint_step,
    latest_checkpoint,
    msgpack_restore_file,
)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "docs/acceptance/tpu_run/rl_model_20480000_steps.msgpack"
ATOL = 1e-5
RTOL = 1e-6


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def knn_obs(m, n, k, goal_in_obs=True, seed=0):
    """A k-NN observation with valid neighbor indices, from numpy."""
    rng = np.random.default_rng(seed)
    width = 2 + 3 * k + (2 if goal_in_obs else 0)
    feats = rng.normal(size=(m, n, width)).astype(np.float32)
    idx = np.stack(
        [rng.permutation(n)[:k] for _ in range(m * n)]
    ).reshape(m, n, k)
    return np.concatenate([feats, idx.astype(np.float32)], -1)


def assert_outputs_close(port, ref):
    for p, r, name in zip(port, ref, ("mean", "log_std", "value")):
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(r), atol=ATOL, rtol=RTOL,
            err_msg=name,
        )


@pytest.mark.parametrize("goal_in_obs", [True, False])
def test_parse_and_gather_match_jax(goal_in_obs):
    obs = knn_obs(2, 9, 3, goal_in_obs)
    jn, je, ji = jax_parse_knn_obs(jnp.asarray(obs), 3, goal_in_obs)
    pn, pe, pi = parse_knn_obs(torch.from_numpy(obs), 3, goal_in_obs)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert pi.dtype == torch.int64
    h = np.random.default_rng(1).normal(size=(2, 9, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        gather_nodes(torch.from_numpy(h), pi).numpy(),
        np.asarray(jax_gather_nodes(jnp.asarray(h), ji)),
    )


@pytest.mark.parametrize(
    "kwargs,masked",
    [
        ({}, False),
        ({}, True),
        ({"rounds": 1, "hidden": (32, 16), "embed_dim": 24, "msg_dim": 16}, True),
        ({"goal_in_obs": False, "log_std_init": -1.5}, False),
    ],
)
def test_gnn_forward_matches_jax(kwargs, masked):
    k, n = 4, 12
    obs = knn_obs(3, n, k, kwargs.get("goal_in_obs", True), seed=2)
    mask = None
    if masked:
        mask = np.random.default_rng(3).uniform(size=(3, n)) < 0.7
    jmodel = JaxGNN(k=k, **kwargs)
    jobs = jnp.asarray(obs)
    jmask = None if mask is None else jnp.asarray(mask)
    jparams = jmodel.init(jax.random.PRNGKey(0), jobs, jmask)
    ref = jmodel.apply(jparams, jobs, jmask)
    model = GNNActorCritic(k=k, **kwargs)
    model.load_state_dict(params_from_jax(np_tree(jparams), "GNNActorCritic"))
    with torch.no_grad():
        port = model(
            torch.from_numpy(obs),
            None if mask is None else torch.from_numpy(mask),
        )
    assert_outputs_close(port, ref)


def _hub_indices(m, n, k, seed):
    """Neighbor indices where a few hub nodes are everyone's neighbors:
    many contributions add into each hub's gradient row."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 3, size=(m, n, k)))


@pytest.mark.parametrize("n", [20, 200])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_gather_gradient_equals_torch_gather(lead, n):
    """C4: the deterministic gather's backwards (the one-hot GEMM at N=20,
    the sorted segment sum above ``ONE_HOT_MAX_N``) against the exact
    gradient (float64): within f32 rounding, the recursive-summation bound
    ``terms * 2**-24 * sum|terms|`` of each row, as ``torch.gather``'s own
    ``scatter_add`` is; the forward is bitwise ``torch.gather``'s."""
    assert (n <= ONE_HOT_MAX_N) == (n == 20)
    k, e = 4, 8
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(*lead, n, e)).astype(np.float32))
    idx = _hub_indices(int(np.prod(lead)) or 1, n, k, 6).reshape(*lead, n, k)
    weights = torch.from_numpy(
        rng.normal(size=(*lead, n, k, e)).astype(np.float32))
    flat = idx.reshape(*lead, n * k, 1).expand(*lead, n * k, e)

    def grad_of(x, w, gather):
        x = x.clone().requires_grad_(True)
        out = gather(x)
        (g,) = torch.autograd.grad((out * w).sum(), x)
        return out, g

    out, got = grad_of(h, weights, lambda x: gather_nodes(x, idx))
    ref, atomic = grad_of(h, weights, lambda x: torch.gather(
        x, -2, flat).reshape(*lead, n, k, e))
    _, exact = grad_of(h.double(), weights.double(), lambda x: torch.gather(
        x, -2, flat).reshape(*lead, n, k, e))
    _, abs_sum = grad_of(h.double(), weights.double().abs(),
                         lambda x: torch.gather(x, -2, flat).reshape(
                             *lead, n, k, e))
    _, terms = grad_of(h.double(), torch.ones_like(weights.double()),
                       lambda x: torch.gather(x, -2, flat).reshape(
                           *lead, n, k, e))
    bound = terms * 2.0 ** -24 * abs_sum
    assert torch.equal(out, ref)
    for g in (got, atomic):
        assert bool(((g.double() - exact).abs() <= bound).all())
    # Rows that nobody lists get exactly zero.
    unused = terms == 0
    assert torch.equal(got[unused], torch.zeros_like(got[unused]))


def test_gather_gradient_under_vmap_equals_the_loop():
    """The population path (``torch.func.vmap`` over members): the member
    axis folds into the batch, bitwise the members' own gathers."""
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(size=(3, 2, 9, 5)).astype(np.float32))
    idx = _hub_indices(6, 9, 3, 8).reshape(3, 2, 9, 3)
    h1 = h.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(
        torch.func.vmap(gather_nodes)(h1, idx).pow(2).sum(), h1)
    h2 = h.clone().requires_grad_(True)
    out = torch.stack([gather_nodes(h2[i], idx[i]) for i in range(3)])
    (g2,) = torch.autograd.grad(out.pow(2).sum(), h2)
    assert torch.equal(g1, g2)


@pytest.mark.parametrize("masked", [False, True])
def test_gnn_gradients_match_jax(masked):
    """The GNN's parameter gradients through the deterministic gather
    against JAX's, within the tolerance the PPO gradients are held to
    (rtol 1e-5, plus 1e-5 of each leaf's largest magnitude)."""
    k, n = 4, 12
    obs = knn_obs(3, n, k, seed=9)
    mask = (np.random.default_rng(10).uniform(size=(3, n)) < 0.7
            if masked else None)
    jmodel = JaxGNN(k=k)
    jobs = jnp.asarray(obs)
    jmask = None if mask is None else jnp.asarray(mask)
    jparams = jmodel.init(jax.random.PRNGKey(3), jobs, jmask)

    def jloss(params):
        mean, log_std, value = jmodel.apply(params, jobs, jmask)
        return (mean ** 2).sum() + value.sum() + log_std.sum()

    jgrads = np_tree(jax.grad(jloss)(jparams))
    model = GNNActorCritic(k=k)
    model.load_state_dict(params_from_jax(np_tree(jparams), "GNNActorCritic"))
    mean, log_std, value = model(
        torch.from_numpy(obs),
        None if mask is None else torch.from_numpy(mask))
    loss = (mean ** 2).sum() + value.sum() + log_std.sum()
    names = [name for name, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    from marl_distributedformation_tpu_torch.compat.convert import (
        params_to_jax,
    )
    from test_torch_algo import assert_tree_close

    assert_tree_close(
        params_to_jax(dict(zip(names, grads)), "GNNActorCritic"), jgrads,
        rtol=1e-5, floor=1e-5, what="grads")


@pytest.mark.parametrize("hidden", [(64, 64), (32,)])
def test_mlp_forward_matches_jax(hidden):
    obs = np.random.default_rng(4).normal(size=(5, 7, 8)).astype(np.float32)
    jmodel = JaxMLP(hidden=hidden, log_std_init=-0.5)
    jparams = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    ref = jmodel.apply(jparams, jnp.asarray(obs))
    model = MLPActorCritic(obs_dim=8, hidden=hidden)
    model.load_state_dict(params_from_jax(np_tree(jparams), "MLPActorCritic"))
    with torch.no_grad():
        assert_outputs_close(model(torch.from_numpy(obs)), ref)


def test_committed_checkpoint_params_on_its_obs():
    raw = load_checkpoint_raw(CKPT)
    jmodel = JaxMLP()
    obs = np.asarray(raw["obs"])
    ref = jmodel.apply({"params": raw["params"]["params"]}, jnp.asarray(obs))
    model = build_model("MLPActorCritic", raw["params"]["params"])
    with torch.no_grad():
        assert_outputs_close(model(torch.from_numpy(obs.copy())), ref)


def test_loaded_policy_predict_matches_jax():
    raw = msgpack_restore_file(CKPT)
    obs = np.asarray(raw["obs"])[:64].reshape(-1, 8)
    ref, _ = JaxLoadedPolicy.from_checkpoint(CKPT).predict(obs)
    pol = LoadedPolicy.from_checkpoint(CKPT, device="cpu")
    got, _ = pol.predict(obs)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    noisy, _ = pol.predict(obs, deterministic=False)
    assert noisy.shape == got.shape and np.abs(noisy).max() <= 1.0


def _assert_trees_equal(a, b, path=""):
    assert type(a) is type(b) or (
        isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
    ), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for key in a:
            _assert_trees_equal(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_checkpoint_reader_matches_jax():
    _assert_trees_equal(msgpack_restore_file(CKPT), load_checkpoint_raw(CKPT))


def test_checkpoint_footer_validated(tmp_path):
    payload = CKPT.read_bytes()
    footer = struct.pack(
        "<Iq8s", zlib.crc32(payload) & 0xFFFFFFFF, len(payload), b"MARLCKPT"
    )
    good = tmp_path / "rl_model_5_steps.msgpack"
    good.write_bytes(payload + footer)
    _assert_trees_equal(msgpack_restore_file(good), load_checkpoint_raw(CKPT))
    bad = tmp_path / "rl_model_7_steps.msgpack"
    bad.write_bytes(payload[:-1] + b"\x00" + footer)
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        msgpack_restore_file(bad)
    short = tmp_path / "rl_model_6_steps.msgpack"
    short.write_bytes(payload[:100] + footer)
    with pytest.raises(CorruptCheckpointError, match="truncated"):
        msgpack_restore_file(short)
    assert latest_checkpoint(tmp_path) == bad
    assert checkpoint_step(good) == 5
    assert latest_checkpoint(tmp_path / "missing") is None


def test_infer_hidden_and_registry():
    raw = msgpack_restore_file(CKPT)["params"]["params"]
    assert infer_hidden(raw, "MLPActorCritic") == (64, 64)
    gnn = np_tree(
        JaxGNN(k=3, hidden=(16, 8)).init(
            jax.random.PRNGKey(0), jnp.asarray(knn_obs(1, 6, 3))
        )
    )["params"]
    assert infer_hidden(gnn, "GNNActorCritic") == (16, 8)
    with pytest.raises(ValueError, match="unknown policy"):
        build_model("TransformerActorCritic", raw)
    with pytest.raises(ValueError, match="no layer"):
        params_from_jax({"params": gnn}, "MLPActorCritic")


def test_distributions_match_jax():
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(6, 2)).astype(np.float32)
    act = rng.normal(size=(6, 2)).astype(np.float32)
    log_std = np.array([-0.3, 0.2], np.float32)
    np.testing.assert_allclose(
        distributions.log_prob(*map(torch.from_numpy, (act, mean, log_std))).numpy(),
        np.asarray(jax_distributions.log_prob(act, mean, log_std)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(distributions.entropy(torch.from_numpy(log_std))),
        float(jax_distributions.entropy(log_std)),
        rtol=1e-6,
    )
    gen = torch.Generator().manual_seed(0)
    draws = distributions.sample(
        gen, torch.zeros(20000, 2), torch.from_numpy(log_std)
    )
    np.testing.assert_allclose(
        draws.std(0).numpy(), np.exp(log_std), rtol=0.03
    )


def test_seeded_init_gains():
    gen = torch.Generator().manual_seed(0)
    model = GNNActorCritic(k=4, generator=gen)
    again = GNNActorCritic(k=4, generator=torch.Generator().manual_seed(0))
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
    w = model.actor.pi_head.weight  # (2, 64), orthogonal rows with gain 0.01
    np.testing.assert_allclose(
        (w @ w.T).detach().numpy(), 1e-4 * np.eye(2), atol=1e-9
    )
    w = model.embed.weight  # (64, 4): orthogonal columns with gain sqrt(2)
    np.testing.assert_allclose(
        (w.T @ w).detach().numpy(), 2.0 * np.eye(4), atol=1e-5
    )
