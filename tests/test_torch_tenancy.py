"""The port's tenant lanes against the JAX package on the CPU.

The port's ``serving/tenancy`` over its fleet, as the JAX package's
``tests/test_tenancy.py`` drives JAX's: the directory validates lanes and
groups them as JAX's groups the same specs; the fleet refuses bad seeds at
construction; admission is per lane; a batch storm on one lane leaves the
quiet lanes admitted and step-flat while a mid-storm swap of the stormed
lane stays monotonic, with one build a (arch, rung, replica) however many
lanes ride it; and the HTTP frontend speaks ``model_id`` end to end. Counts
and invariants are bounded, never timing (C2). A lane's served actions are
held against its own policy's ``predict`` within rtol 1e-5 (the rungs'
tensors take the lane's snapshot by ``copy_``).
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from marl_distributedformation_tpu.serving.tenancy import (
    TenantDirectory as JaxTenantDirectory,
    TenantSpec as JaxTenantSpec,
)
from marl_distributedformation_tpu_torch import serve as serve_cli
from marl_distributedformation_tpu_torch.chaos import check_budget_one
from marl_distributedformation_tpu_torch.compat.convert import params_to_jax
from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
from marl_distributedformation_tpu_torch.models import MLPActorCritic
from marl_distributedformation_tpu_torch.serving import BackpressureError
from marl_distributedformation_tpu_torch.serving.fleet import FleetFrontend
from marl_distributedformation_tpu_torch.serving.tenancy import (
    TenantDirectory,
    TenantFleet,
    TenantSpec,
    run_tenant_smoke,
    tenant_fleet_from_directory,
)
from marl_distributedformation_tpu_torch.utils.checkpoint import (
    save_checkpoint,
)

OBS_DIM = 8  # both registered envs' default rows are 8-wide
HIDDEN = (8, 8)


def _make_policy(seed=0, hidden=HIDDEN, obs_dim=OBS_DIM):
    model = MLPActorCritic(obs_dim, hidden=hidden,
                           generator=torch.Generator().manual_seed(seed))
    return LoadedPolicy(model.eval())


def _write_ckpt(log_dir, step, policy):
    return save_checkpoint(log_dir, step, {
        "policy": type(policy.model).__name__,
        "params": params_to_jax(dict(policy.model.named_parameters()),
                                type(policy.model).__name__),
        "num_timesteps": step,
    })


def _obs(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, OBS_DIM))
            .astype(np.float32))


SPECS = (
    dict(model_id="formation-a", env="formation", hidden=HIDDEN),
    dict(model_id="formation-b", env="formation", hidden=HIDDEN),
    dict(model_id="pursuit", env="pursuit_evasion", hidden=(16, 16)),
)


def _directory(tmp_path=None, specs=SPECS):
    """Two same-arch formation lanes and one pursuit lane of another
    architecture; with ``tmp_path``, each lane gets its own promoted
    directory with a seed checkpoint at step 100, 200, 300."""
    out = []
    for i, spec in enumerate(specs):
        spec = dict(spec)
        if tmp_path is not None:
            d = tmp_path / spec["model_id"] / "promoted"
            _write_ckpt(d, 100 * (i + 1),
                        _make_policy(i, hidden=spec["hidden"]))
            spec["promoted_dir"] = d
        out.append(TenantSpec(**spec))
    return TenantDirectory(out)


# ---------------------------------------------------------------------------
# The directory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad, match", [
    (dict(model_id=""), "model_id"),
    (dict(model_id="a__b"), "model_id"),
    (dict(model_id="-leading"), "model_id"),
    (dict(model_id="sp ace"), "model_id"),
    (dict(model_id="semi;colon"), "model_id"),
    (dict(model_id="a", slo_class="platinum"), "slo_class"),
    (dict(model_id="a", policy="TransformerXXL"), "policy"),
    (dict(model_id="a", env="fromation"), "did you mean 'formation'"),
])
def test_directory_validates_lane_declarations_as_jax(bad, match):
    """Each bad declaration fails at declaration time in both packages."""
    with pytest.raises(ValueError, match=match):
        TenantSpec(**bad)
    with pytest.raises(ValueError, match=match):
        JaxTenantSpec(**bad)


def test_directory_lookup_and_duplicates():
    d = _directory()
    assert list(d) == ["formation-a", "formation-b", "pursuit"]
    assert "pursuit" in d and len(d) == 3
    with pytest.raises(KeyError, match="did you mean 'formation-a'"):
        d.get("formation_a")
    with pytest.raises(ValueError, match="duplicate"):
        d.add(TenantSpec(model_id="pursuit"))


GROUPINGS = {
    "jax_test": SPECS,
    "widths_split": (dict(model_id="a", hidden=(8, 8)),
                     dict(model_id="b", hidden=(8, 16)),
                     dict(model_id="c", hidden=(8, 8))),
    "agents_split": (dict(model_id="a", num_agents=5),
                     dict(model_id="b", num_agents=10),
                     dict(model_id="c", num_agents=5)),
    "envs_share": (dict(model_id="a", env="formation"),
                   dict(model_id="b", env="pursuit_evasion")),
    "act_split": (dict(model_id="a", act_dim=2),
                  dict(model_id="b", act_dim=3)),
}


@pytest.mark.parametrize("case", sorted(GROUPINGS))
def test_arch_groups_match_jax(case):
    """The same specs give the same lane partition as JAX's directory,
    and for flat (MLP) lanes the same signature strings."""
    specs = GROUPINGS[case]
    ours = TenantDirectory(TenantSpec(**s) for s in specs).arch_groups()
    theirs = JaxTenantDirectory(JaxTenantSpec(**s) for s in specs
                                ).arch_groups()
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ([s.model_id for s in ours[key]]
                == [s.model_id for s in theirs[key]])


def test_per_formation_lanes_serve_formations():
    """A GNN lane's row is a whole formation, and its agent count and k
    join the signature (its captured forward holds both)."""
    knn = {"obs_mode": "knn", "knn_k": 4}
    a = TenantSpec(model_id="a", policy="GNNActorCritic", num_agents=100,
                   env_overrides=knn)
    b = TenantSpec(model_id="b", policy="GNNActorCritic", num_agents=100,
                   env_overrides=dict(knn, knn_k=2))
    assert a.row_shape == (100, a.obs_dim)
    assert a.arch_key() != b.arch_key()
    assert "_n100_k4" in a.arch_key()


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


def test_fleet_construction_is_fail_fast():
    d = _directory()
    policies = {
        "formation-a": _make_policy(0),
        "formation-b": _make_policy(1),
        "pursuit": _make_policy(2, hidden=(16, 16)),
    }
    with pytest.raises(ValueError, match="no seed policy"):
        TenantFleet(d, {k: policies[k] for k in ("formation-a", "pursuit")},
                    devices=["cpu"])
    with pytest.raises(ValueError, match="undeclared"):
        TenantFleet(d, {**policies, "ghost": _make_policy(3)},
                    devices=["cpu"])
    with pytest.raises(ValueError, match="cannot share"):
        TenantFleet(d, {**policies,
                        "formation-b": _make_policy(1, hidden=(4, 4))},
                    devices=["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        TenantFleet(TenantDirectory(), {}, devices=["cpu"])


def test_admission_is_per_lane():
    """Lane A's full queue rejects lane A's next request with a lane-A
    Retry-After while lane B is still admitted and served."""
    d = TenantDirectory([TenantSpec(model_id="lane-a", hidden=HIDDEN),
                         TenantSpec(model_id="lane-b", hidden=HIDDEN)])
    fleet = TenantFleet(
        d, {"lane-a": _make_policy(0), "lane-b": _make_policy(0)},
        devices=["cpu"], num_replicas=1, buckets=(1,), window_ms=0.0,
        tenant_max_queue=1, probe_interval_s=60.0,
    )
    fleet.warmup()
    (replica,) = fleet.replicas
    orig = replica.engine.act

    def slow_act(*args, **kwargs):
        time.sleep(0.3)
        return orig(*args, **kwargs)

    replica.engine.act = slow_act
    with fleet:
        in_flight = fleet.submit(_obs(1, seed=0), model_id="lane-a")
        time.sleep(0.05)  # the worker takes it and blocks in slow_act
        queued = fleet.submit(_obs(1, seed=1), model_id="lane-a")
        with pytest.raises(BackpressureError) as exc:
            fleet.submit(_obs(1, seed=2), model_id="lane-a")
        assert exc.value.retry_after_s > 0.0
        other = fleet.submit(_obs(1, seed=3), model_id="lane-b")
        for fut in (in_flight, queued, other):
            assert fut.result(timeout=30).actions.shape == (1, 2)
        snap = fleet.snapshot()
        assert snap["model_lane-a__rejected_total"] == 1.0
        assert snap["model_lane-b__rejected_total"] == 0.0
        with pytest.raises(ValueError, match="model_id"):
            fleet.submit(_obs(1, seed=4))
        with pytest.raises(ValueError, match="did you mean"):
            fleet.submit(_obs(1, seed=4), model_id="lane_a")
        res = fleet.submit(_obs(1, seed=5), model_id="lane-b").result(
            timeout=30)
        assert res.model_id == "lane-b"


def test_tenant_storm_isolation_shared_rungs_and_midstorm_swap(tmp_path):
    """A batch storm on formation-a with a mid-storm swap of formation-a:
    every lane served, every lane step-monotonic, the quiet lanes never
    rejected and step-flat, the swapped lane 100 -> 150, one build a
    (arch, rung, replica) over two groups, and no accepted request lost.
    Bounds counts and invariants, not timing (C2)."""
    d = _directory(tmp_path)
    fleet = tenant_fleet_from_directory(
        d, device="cpu", num_replicas=2, buckets=(1, 8), watch=False)
    coord = fleet.coordinators["formation-a"]
    swap = {"committed": False}

    def mid_storm():
        _write_ckpt(d.get("formation-a").promoted_dir, 150, _make_policy(7))
        swap["committed"] = coord.refresh()

    with fleet:
        report = run_tenant_smoke(
            fleet, sizes=(1, 3, 8), duration_s=2.0, clients_per_lane=2,
            storm_lane="formation-a", storm_clients=3, mid_storm=mid_storm,
            mid_storm_at_s=0.2,
        )
    assert swap["committed"]
    assert coord.last_commit["model_id"] == "formation-a"
    for mid in ("formation-a", "formation-b", "pursuit"):
        assert report[f"model_{mid}__requests_ok"] > 0, report
        assert report[f"model_{mid}__step_monotonic_violations"] == 0.0
        assert report[f"model_{mid}__failed"] == 0.0
        assert report[f"model_{mid}__timed_out"] == 0.0
    for mid, step in (("formation-b", 200.0), ("pursuit", 300.0)):
        assert report[f"model_{mid}__rejected"] == 0.0
        assert report[f"model_{mid}__step_min"] == step
        assert report[f"model_{mid}__step_max"] == step
    assert report["model_formation-a__step_min"] == 100.0
    assert report["model_formation-a__step_max"] == 150.0
    assert np.isfinite(report["tenant_isolation_p95_ratio"])
    shared = report["shared_rung_compiles"]
    assert len(shared) == 4  # 2 arch groups x 2 rungs
    assert all(count == 1 for count in shared.values()), shared
    assert check_budget_one(shared) == []
    # The fleet's own counters saw every routed request.
    routed = sum(report[f"model_{m}__requests_total"] for m in fleet.lane_ids)
    done = sum(report[f"model_{m}__{k}"] for m in fleet.lane_ids
               for k in ("requests_ok", "rejected"))
    assert routed == done


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url + "/v1/act", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def test_frontend_speaks_model_id_end_to_end():
    d = TenantDirectory([TenantSpec(model_id="lane-a", hidden=HIDDEN),
                         TenantSpec(model_id="lane-b", hidden=HIDDEN)])
    policies = {"lane-a": _make_policy(0), "lane-b": _make_policy(1)}
    fleet = TenantFleet(d, policies, steps={"lane-a": 11, "lane-b": 22},
                        devices=["cpu"], num_replicas=2, buckets=(1, 8))
    fleet.warmup()
    obs = _obs(3, seed=9)
    with fleet, FleetFrontend(fleet, port=0) as frontend:
        for mid, step in (("lane-a", 11), ("lane-b", 22)):
            body = _post(frontend.url, {"obs": obs.tolist(),
                                        "model_id": mid})
            ref, _ = policies[mid].predict(obs, deterministic=True)
            np.testing.assert_allclose(
                np.asarray(body["actions"], np.float32), ref, rtol=1e-5,
                atol=1e-6)
            assert body["model_id"] == mid and body["model_step"] == step
        a, _ = policies["lane-a"].predict(obs, deterministic=True)
        b, _ = policies["lane-b"].predict(obs, deterministic=True)
        assert not np.allclose(a, b)
        for payload, needle in (
            ({"obs": obs.tolist()}, "model_id is required"),
            ({"obs": obs.tolist(), "model_id": "lane_a"}, "did you mean"),
        ):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(frontend.url, payload)
            assert e.value.code == 400
            assert needle in json.loads(e.value.read())["error"]
        health = json.loads(urllib.request.urlopen(
            frontend.url + "/v1/health", timeout=10).read())
        assert health["model_steps"] == {"lane-a": 11, "lane-b": 22}
        assert health["model_step"] == 22
        req = urllib.request.Request(frontend.url + "/v1/metrics",
                                     headers={"Accept": "text/plain"})
        text = urllib.request.urlopen(req, timeout=10).read().decode()
        assert 'marl_model_step{model="lane-a"} 11.0' in text
        assert 'marl_model_step{model="lane-b"} 22.0' in text


# ---------------------------------------------------------------------------
# The serve CLI's --tenants
# ---------------------------------------------------------------------------


def test_serve_cli_tenants_smoke(tmp_path, capsys):
    d = _directory(tmp_path)
    pairs = ",".join(f"{s.model_id}={s.promoted_dir}" for s in d.lanes())
    rc = serve_cli.main(["--fleet", "--tenants", pairs, "--replicas", "1",
                         "--buckets", "1,8", "--duration", "0.4",
                         "--clients", "3", "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for s in d.lanes():
        assert report[f"model_{s.model_id}__requests_ok"] > 0
    assert report["max_shared_rung_compiles"] == 1.0
    assert len(report["shared_rung_compiles"]) == 4


@pytest.mark.parametrize("argv, match", [
    (["--tenants", "a=x"], "requires --fleet"),
    (["--fleet", "--tenants", "a"], "NAME=DIR"),
    (["--fleet", "--tenants", "a=x,a=y"], "twice"),
    (["--fleet", "--tenants", "a=nowhere"], "no rl_model"),
    (["logs/run", "--fleet", "--tenants", "a=x"], "names each lane"),
])
def test_serve_cli_tenants_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve_cli.main([*argv, "--device", "cpu"])
