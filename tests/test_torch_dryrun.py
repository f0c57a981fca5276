"""The port's dry run (``repro_torch.launch.dryrun``) and its report on the
CPU: one arch's four cells at smoke width partitioned on a ``(4, 2)``
``DeviceMesh`` over a fake group (``count_cell`` and
``roofline.analyze``, which ``run_cell`` wraps), each against the
counter and the sharding rules it is made from (per-device terms as
counted, a collective term), the resumable JSON files of the CLI,
``report``'s tables (the collective columns, "fits?" against the device
model's 80 GiB), the production mesh at full width for one decode cell,
and the ``--backend sim`` stencil cells."""
import json
import math

import pytest
import torch

from repro_torch import configs as TC
from repro_torch import roofline
from repro_torch.configs.shapes import SHAPES, cell_supported
from repro_torch.dist import sharding as shd
from repro_torch.dist.mesh import ShardMesh
from repro_torch.launch import dryrun, report, tuning
from repro_torch.launch.mesh import fake_device_mesh
from repro_torch.models.registry import build_model, count_active_params

ARCH = "qwen2.5-3b"
MESH = ShardMesh((4, 2), ("data", "model"), ["meta"] * 8)


@pytest.fixture(scope="module")
def records():
    """Each supported cell's knobs, memory per device and roofline."""
    cfg0 = TC.get_smoke_config(ARCH)
    out = {}
    with fake_device_mesh((4, 2), ("data", "model")) as mesh:
        for shape, cell in SHAPES.items():
            if not cell_supported(cfg0, shape)[0]:
                continue
            cfg, knobs = tuning.tuned(cfg0, shape, MESH)
            cost, mem = dryrun.count_cell(cfg, cell, mesh, knobs)
            rl = roofline.analyze(cost, 8, dryrun.model_flops(cfg0, cell),
                                  hw="gpu_sm90")
            out[shape] = {"accum_steps": knobs.accum_steps, "memory": mem,
                          "roofline": rl.as_dict(), "cost": cost}
    return out


def test_four_cells_at_smoke_width(records):
    cfg0 = TC.get_smoke_config(ARCH)
    ok, why = cell_supported(cfg0, "long_500k")
    assert not ok and "sub-quadratic" in why
    assert sorted(records) == ["decode_32k", "prefill_32k", "train_4k"]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = records[shape]
        cell = SHAPES[shape]
        rl, cost = rec["roofline"], rec["cost"]
        assert rl["n_devices"] == 8
        # per device as counted on rank 0's local shapes, no even split
        assert rl["compute_s"] == pytest.approx(cost.dot_flops / 989e12)
        assert rl["flops"] == 8 * cost.dot_flops
        assert rl["memory_s"] == pytest.approx(
            cost.hbm_proxy_bytes / 3.35e12)
        hw = roofline.resolve_hw("gpu_sm90")
        assert rl["coll_bytes"] == int(cost.collective_bytes) > 0
        assert rl["collective_s"] == pytest.approx(
            cost.collective_bytes / hw["ici_bw"])
        assert cost.collective_count == 0 or cost.collective_by_op
        assert sum(cost.collective_by_op.values()) == pytest.approx(
            cost.collective_bytes)
        assert rl["cross_pod_bytes"] == 0 and rl["collective_reason"] is None
        assert rl["bound_s"] == max(rl["compute_s"], rl["memory_s"],
                                    rl["collective_s"])
        assert rl["model_flops"] == dryrun.model_flops(cfg0, cell)
        mem = rec["memory"]
        assert mem["total_nonalias"] == (
            mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
        assert mem["temp_size_in_bytes"] > 0
    assert records["train_4k"]["accum_steps"] == 256 // 4
    # train: the state's parameters and two f32 moments, exact per device
    model = build_model(tuning.tuned(cfg0, "train_4k", MESH)[0],
                        device="meta")
    axes = model.logical_axes()
    per_dev = sum(shd.shard_bytes(p.shape, 4, shd.pspec_for(
        axes[n], p.shape, MESH), MESH) for n, p in model.named_parameters())
    batch = 2 * 256 * 4096 * 8 // 4  # tokens and labels, int64, over data
    mem = records["train_4k"]["memory"]
    assert mem["argument_size_in_bytes"] == 3 * per_dev + batch + 4
    assert mem["alias_size_in_bytes"] == 3 * per_dev
    # a train cell's useful ratio: 6 N D over the counted flops
    rl = records["train_4k"]["roofline"]
    assert rl["model_flops"] == 6 * count_active_params(cfg0) * 256 * 4096
    assert 0 < rl["useful_ratio"] < 1


def test_cli_writes_resumable_records_and_report(tmp_path, capsys):
    argv = ["--arch", ARCH, "--mesh", "pod", "--shape", "decode_32k",
            "--outdir", str(tmp_path)]
    assert dryrun.main(argv) == 0
    path = tmp_path / "pod" / f"{ARCH}.decode_32k.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["device_model"] == "gpu_sm90"
    assert rec["accum_steps"] == tuning.tuned(
        TC.get_config(ARCH), "decode_32k",
        dryrun.make_production_mesh())[1].accum_steps
    assert rec["count_s"] >= 0 and rec["cost"]["ops"] > 0
    assert rec["cost"]["collective_count"] > 0
    assert rec["cost"]["collective_by_op"]
    assert rec["roofline"]["collective_s"] > 0
    assert "[ok     ] pod" in capsys.readouterr().out
    assert dryrun.main(argv) == 0
    assert "[cached ]" in capsys.readouterr().out
    recs = report.load(str(tmp_path))
    table = report.roofline_table(recs, "pod")
    row = table.splitlines()[2]
    assert row.startswith(f"| {ARCH} | decode_32k | ✓ |")
    assert "| — |" not in row and "memory" in row
    coll = f"{rec['roofline']['coll_bytes']:.2e}"
    assert f"| ok |" in report.dryrun_table(recs)
    assert report.dryrun_table(recs).splitlines()[2].endswith(
        f"| {coll} |")
    report.main(["--dir", str(tmp_path), "--which", "dryrun"])
    assert f"| pod | {ARCH} | decode_32k | ok" in capsys.readouterr().out


def test_full_width_decode_cell_on_the_pod_mesh():
    """The production mesh at full width, all on meta: the cache of 36
    layers, 128 sequences of 32768 tokens and 2 KV heads (36 x 128 x
    32768 x 2 x 128 x 2 bf16 bytes each for K and V) is laid out by the
    reference's rules: batch over data, kv_seq over model (2 heads do
    not divide 16)."""
    rec = dryrun.run_cell(ARCH, "decode_32k", "pod")
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg = TC.get_config(ARCH)
    kv = 2 * 36 * 128 * 32768 * 2 * 128 * 2
    params = sum(math.prod(p.shape) for p in build_model(
        cfg, device="meta").parameters())
    mem = rec["memory"]
    assert mem["alias_size_in_bytes"] == kv // 256
    assert mem["argument_size_in_bytes"] > kv // 256 + params * 2 // 256
    assert report.roofline_table([rec], "pod").count("✓") == 1


def test_sim_backend_cells(tmp_path):
    assert dryrun.main(["--backend", "sim", "--device", "cpu", "--outdir",
                        str(tmp_path)]) == 0
    recs = sorted((tmp_path / "sim").glob("*.json"))
    assert recs
    for f in recs:
        rec = json.loads(f.read_text())
        assert rec["status"] == "ok" and rec["summary"]["gpts"] > 0
    assert report.load(str(tmp_path)) == []


def test_cell_inputs_off_meta():
    cfg = TC.get_smoke_config("internvl2-2b")
    cell = SHAPES["train_4k"].__class__("t", 64, 2, "train")
    g = torch.Generator().manual_seed(0)
    batch = dryrun.cell_inputs(cfg, cell, "cpu", g)
    assert batch["tokens"].dtype == torch.int64
    assert batch["tokens"].shape == (2, 64 - cfg.vlm_image_tokens)
    assert int(batch["tokens"].max()) < cfg.vocab_size
    assert batch["image_embeds"].dtype == torch.bfloat16
