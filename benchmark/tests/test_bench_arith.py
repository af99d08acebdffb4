"""The frozen measurement arithmetic on hand-worked shapes."""

import json

import pytest

from benchmark import harness, roofline
from benchmark.trace import Profile, busy_union_us, idle_gaps


def config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("shape, ms, by", [
    ((1024, 100, 4), 0.0022, "bytes"),  # gnn100's training search
    ((4096, 100, 4), 0.0088, "bytes"),  # the eval cell's
    ((512, 1024, 4), 0.0480, "operations"),  # eval at N=1024
])
def test_knn_bound(shape, ms, by):
    bound_s, what = roofline.knn_bound_s(*shape)
    # (1024, 100, 4): 1024*100*8 + 1024*100*4*16 = 7,372,800 bytes over
    # 3.35 TB/s = 2.2009e-6 s; 1024*100*99*6 operations over 67 TFLOP/s
    # = 0.908e-6 s.
    assert what == by
    assert bound_s * 1e3 == pytest.approx(ms, rel=0.01)


def test_knn_bound_exact():
    bound_s, _ = roofline.knn_bound_s(1024, 100, 4)
    assert bound_s == pytest.approx(7_372_800 / 3.35e12, rel=1e-12)


def test_gnn_forward_flops():
    # embed 2*4*64 = 512; a round: 4 messages of 2*131*64 = 67,072 and an
    # update of 2*132*64 = 16,896; actor 2*64*64 + 2*64*2 = 8,448; critic
    # 2*128*64 + 2*64*1 = 16,512.
    want = 512 + 2 * (67_072 + 16_896) + 8_448 + 16_512
    assert roofline.forward_flops(config("gnn100")["model"]) == want
    assert want == 193_408


def test_mlp_forward_flops():
    # Two towers 8 -> 64 -> 64, heads to 2 and to 1.
    want = 2 * (8 * 64 + 64 * 64) * 2 + 2 * 64 * 2 + 2 * 64 * 1
    assert roofline.forward_flops(config("ring5")["model"]) == want == 18_816


def test_update_rows():
    # gnn100: 10 * 1024 formations, 16384 // 100 = 163 a minibatch, 62 of
    # them; ring5: 10 * 4096 * 5 agents, 12 minibatches of 16384.
    assert roofline.update_rows(config("gnn100")) == (10_240, 163, 62)
    assert roofline.update_rows(config("ring5")) == (204_800, 16_384, 12)


def test_train_iteration_flops():
    g = config("gnn100")
    rollout = 11 * 1024 * 100 * 193_408
    update = 3 * 10 * (62 * 163 * 100) * 193_408
    assert roofline.train_iteration_flops(g) == rollout + update
    r = config("ring5")
    assert roofline.train_iteration_flops(r) == (
        11 * 4096 * 5 * 18_816 + 3 * 10 * 12 * 16_384 * 18_816)


def test_eval_step_flops():
    # The action alone: the GNN's forward less its critic tower (16,512).
    assert roofline.eval_step_flops(config("gnn100"), 4096) == (
        4096 * 100 * (193_408 - 16_512))
    # The MLP's policy tower and head: 2 * (8 * 64 + 64 * 64 + 64 * 2).
    assert roofline.eval_step_flops(config("ring5"), 10) == 10 * 5 * 9_472


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 30), (21, 22), (40, 41)]
    assert busy_union_us(spans) == 12 + 10 + 1
    assert idle_gaps(spans) == [(12, 20), (30, 40)]
    assert busy_union_us([]) == 0


def test_idle_by_host_names_the_innermost_host_op():
    p = Profile.__new__(Profile)
    p.device = [("k1", 0.0, 10.0), ("k2", 20.0, 30.0), ("k3", 50.0, 60.0)]
    p.host = [("outer", 0.0, 100.0), ("cudaGraphLaunch", 12.0, 18.0)]
    # Gap (10, 20): middle 15 lies in cudaGraphLaunch, inside outer; gap
    # (30, 50): middle 40 in outer only.
    assert p.idle_by_host() == [["outer", 20e-6], ["cudaGraphLaunch", 10e-6]]
    assert p.device_ops() == [["k1", 10e-6], ["k2", 10e-6], ["k3", 10e-6]]
    assert p.kernels("k2") == [10.0]


def test_layer_readers_return_nothing_without_readings():
    from benchmark.readings import Readings

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    empty = Readings(config=config("gnn100"))
    cell = harness.Cell("gnn100.train")
    for metric in spec["per_layer"]:
        assert cell.reader(metric["name"]).read(empty) is None, metric


def test_spec_names_files_that_exist():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.driver().drive
        assert set(cell.limits)
    for m in spec["per_layer"]:
        assert (harness.HERE / "layers" / f"{m['name']}.py").exists()
    assert json.dumps(spec)
