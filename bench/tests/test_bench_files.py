"""The benchmark's files are found by name, its generators repeat per
seed, and its arithmetic (least work, percentiles, busy unions, idle
shares, the trace's reduction) is right."""
import json
import math
import re
import statistics

import pytest
import torch

from bench import checks, devicetrace, harness, inputs, roofline, stats

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry, cfg_entry = harness.find_cell(BENCH, cell)
    cfg = harness.load_config(cfg_entry)
    assert cfg["name"] == cfg_entry["name"]
    assert cfg["reduced"] == cfg_entry["reduced"] == []
    assert "assumed" in cfg and "limits" in cfg
    traffic = harness.load_traffic(entry["traffic"])
    assert traffic["entry"] in ("run", "serve")
    e2e = harness.metrics_for(BENCH, cell, trace=False)
    per = harness.metrics_for(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    for m in e2e + per:
        assert callable(harness.reader(m["name"]))


def test_per_layer_metrics_move_a_metric_of_their_cells():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  harness.metrics_for(BENCH, cell, False)}


def test_grids_repeat_per_seed_and_differ_per_input():
    cfg = harness.load_config(BENCH["configs"][0])
    cfg = dict(cfg, ny=8, nx=12)
    cpu = torch.device("cpu")
    seed = 2 ** 31 + 11
    a = inputs.make_grid(cfg, seed, inputs.TIMED, 3, cpu)
    assert torch.equal(a, inputs.make_grid(cfg, seed, inputs.TIMED, 3, cpu))
    assert not torch.equal(a, inputs.make_grid(cfg, seed, inputs.TIMED, 4,
                                               cpu))
    assert not torch.equal(a, inputs.make_grid(cfg, seed + 1, inputs.TIMED,
                                               3, cpu))
    assert a.dtype == torch.bfloat16 and a.shape == (10, 14)
    assert (a[1:-1, 0] == 1).all() and (a[0] == 0).all()
    assert (a[-1] == 0).all() and (a[1:-1, -1] == 0).all()
    inner = a[1:-1, 1:-1].float()
    assert (inner >= 0).all() and (inner < 1).all()


def test_stream_seeds_take_large_seeds():
    s = {inputs.stream_seed(seed, tag, i) for seed in (0, 2 ** 31 + 5,
                                                       2 ** 40, -3)
         for tag in range(3) for i in range(3)}
    assert len(s) == 36 and all(0 <= x < 2 ** 63 for x in s)


def _curve():
    return [1.0 / (1 + b) ** 1.5 for b in range(125)]


def test_tolerance_deck_repeats_and_deals_whole():
    traffic = harness.load_traffic("served")
    mix = inputs.Mix(traffic, 5, _curve())
    again = inputs.Mix(traffic, 5, _curve())
    n = len(mix.deck)
    assert n == 8 and mix.deck.count(None) == 1
    tols = [mix.tol(k) for k in range(5 * n)]
    assert tols == [again.tol(k) for k in range(5 * n)]
    for c in range(5):
        deal = tols[c * n:(c + 1) * n]
        assert sorted(deal, key=lambda x: (x is None, x)) == sorted(
            mix.deck, key=lambda x: (x is None, x))
    other = inputs.Mix(traffic, 6, _curve())
    assert [other.tol(k) for k in range(5 * n)] != tols


def test_spread_tols_converge_at_their_blocks():
    curve = _curve()
    for blocks, tol in inputs.spread_tols(curve, 7):
        assert curve[blocks - 1] <= tol < min(curve[:blocks - 1])


def test_reservoir_is_uniform_and_bounded():
    hits = [0] * 10
    for seed in range(2000):
        r = inputs.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        assert len(r.items) == 2
        for i in r.items:
            hits[i] += 1
    assert all(300 < h < 500 for h in hits)


def test_least_work_of_the_paper_domain():
    flops = roofline.solve_flops(1024, 9216, 4, 5000)
    assert flops == 4 * 1024 * 9216 * 5000
    nbytes = roofline.solve_bytes(1024, 9216, 1, "bfloat16")
    assert nbytes == (1026 * 9218 + 1024 * 9216) * 2
    s, bound = roofline.least_time(flops, nbytes, "NVIDIA H100 80GB HBM3")
    assert bound == "arithmetic"
    assert s == pytest.approx(flops / 67e12)
    small = roofline.least_time(1.0, 1e9, "NVIDIA H100 PCIe")
    assert small == (1e9 / 3.35e12, "memory")
    with pytest.raises(KeyError):
        roofline.peaks("NVIDIA A100")


def test_percentile_is_nearest_rank():
    xs = list(range(1, 201))
    assert stats.percentile(xs, 95) == 190
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile(list(reversed(xs)), 50) == 100
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_uses_the_statistics_quartiles():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / q2


def test_busy_union_gaps_and_idle():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 9.5)]
    assert stats.merge(iv) == [(0, 3), (5, 7), (9, 9.5)]
    assert stats.union_length(iv) == 5.5
    assert stats.gaps(iv) == [(3, 5), (7, 9)]
    assert stats.idle_share(5.5, 10.0) == pytest.approx(45.0)


def test_trace_reduction_names_gaps_by_the_host():
    ms = 1_000_000
    events = [
        ("bench.solve", False, 0, 10 * ms, 1),
        ("cudaLaunchKernel", False, 1 * ms, 2 * ms, 1),
        ("bench.sync", False, 10 * ms, 20 * ms, 1),
        ("cudaDeviceSynchronize", False, 10 * ms, 20 * ms, 1),
        ("worker", False, 0, 30 * ms, 2),
        ("K1", True, 2 * ms, 12 * ms, 0),
        ("K1", True, 15 * ms, 16 * ms, 0),
        ("copy", True, 16 * ms, 17 * ms, 0),
    ]
    red = devicetrace.reduce(events)
    assert red["busy_s"] == pytest.approx(0.012)
    assert red["device_ops"][0] == ["K1", pytest.approx(0.011)]
    assert red["idle_gaps"] == [["bench.sync/cudaDeviceSynchronize",
                                 pytest.approx(0.003)]]
    assert devicetrace.reduce([]) == {"busy_s": 0.0, "device_ops": [],
                                      "idle_gaps": []}


def test_metric_readers_on_a_context():
    ctx = {"setup_s": 4.0, "window_s": 20.0, "work_points": 4e13,
           "solves": 400, "launches": 250000, "least_time_s": 1.0,
           "busy_s": 19.8, "trace_window_s": 20.0, "served_completed": 500,
           "latencies_s": [0.1] * 190 + [0.5] * 10, "server_launches": 600,
           "server_completed": 500}
    got = {m: harness.reader(m)(ctx) for m in (
        "gpts", "setup_s", "kernel_roofline_share.solve",
        "launches_per_solve", "device_idle_share.solve",
        "device_idle_share.served", "served_solves_per_s", "served_p95_ms",
        "launches_per_request.served")}
    assert got == {"gpts": 2000.0, "setup_s": 4.0,
                   "kernel_roofline_share.solve": pytest.approx(100 / 19.8),
                   "launches_per_solve": 625.0,
                   "device_idle_share.solve": pytest.approx(1.0),
                   "device_idle_share.served": pytest.approx(1.0),
                   "served_solves_per_s": 25.0,
                   "served_p95_ms": pytest.approx(100.0),
                   "launches_per_request.served": 1.2}
    assert harness.reader("kernel_roofline_share.solve")({"setup_s": 1}) \
        is None


def test_forbidden_modules_compare_whole_names():
    assert checks.forbidden_modules(["repro_torch", "repro_torch.engine",
                                     "jaxtyping", "numpy"]) == []
    assert checks.forbidden_modules(["repro.core", "jax._src", "jaxlib",
                                     "flax.linen"]) == ["flax", "jax",
                                                        "jaxlib", "repro"]


def test_max_abs_diff_fails_what_is_not_finite():
    a = torch.zeros(3, 3)
    assert checks.max_abs_diff(a, a) == 0.0
    b = a.clone()
    b[1, 1] = math.nan
    assert checks.max_abs_diff(b, a) == checks.NON_FINITE
    assert checks.max_abs_diff(a[:2], a) == checks.NON_FINITE
    assert not checks.passed([checks.check("x", checks.NON_FINITE, 0.1)])


def test_result_line_puts_the_checks_last():
    run = harness.Run(cell="jacobi-bf16.fixed", cfg={}, traffic={}, seed=1,
                      seconds=1, trace=False, device=torch.device("cpu"),
                      t_start=0.0)
    out = {"ctx": {"setup_s": 2.0, "work_points": 1e9, "window_s": 1.0},
           "checks": [checks.check("grid_max_abs_diff", 0.0, 0.0)],
           "correct": True, "attempted": 3, "failed": 0,
           "memory_peak_bytes": 5, "device_kind": "cpu"}
    line = harness.result_line(BENCH, run, out, 1)
    assert list(line)[-1] == "checks"
    assert line["metrics"] == {"gpts": {"value": 1.0, "unit": "Gpt/s"},
                               "setup_s": {"value": 2.0, "unit": "s"}}
    json.dumps(line)
