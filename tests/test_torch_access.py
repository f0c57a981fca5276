"""``python -m repro_torch.launch.access``, the port's Tables II–VI, on
the CPU.

At ``--scale 4`` Tables III–V's 4096 x 4096 arrays shrink to the JAX
tables' 1024 x 1024, so the port's measured rows must carry exactly the
names of the JAX tables' measured rows (read from those modules in their
dry mode, ``REPRO_BENCH_DRY=1``), less the ``sim_*`` rows of the
simulator the port does not have yet; the ``paper_*`` rows must equal the
JAX tables' rows as they are.
"""
import importlib
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import access

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TABLES = {2: "table2_components", 3: "table3_access_contig",
              4: "table4_access_noncontig", 5: "table5_replication",
              6: "table6_interleave"}


@pytest.fixture(scope="module")
def cpu_run():
    """One CPU run of every table at scale 4: rows by table."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        access.main(["--device", "cpu", "--scale", "4"])
    tables, current = {}, None
    for line in buf.getvalue().splitlines():
        if line.startswith("# === "):
            current = int(line.split("(table")[1][0])
            tables[current] = []
        elif current is not None and not line.startswith("#"):
            tables[current].append(line)
    return buf.getvalue(), tables


def test_csv_contract(cpu_run):
    text, tables = cpu_run
    lines = text.splitlines()
    assert lines[0].startswith("# device: cpu")
    assert lines[1] == "name,us_per_call,derived"
    assert sorted(tables) == [2, 3, 4, 5, 6]
    for rows in tables.values():
        for line in rows:
            name, us, derived = line.split(",")
            assert name and derived and "v5e" not in derived
            if name.startswith("paper_"):
                assert float(us) == 0.0
            else:
                assert float(us) > 0.0
                assert "model_sm90_" in derived


@pytest.mark.parametrize("table", sorted(JAX_TABLES))
def test_rows_match_the_jax_tables(cpu_run, table, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_DRY", "1")
    mod = importlib.import_module(f"benchmarks.{JAX_TABLES[table]}")
    want = [line for line in mod.run() if not line.startswith("sim_")]
    got = cpu_run[1][table]
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    paper = [r for r in want if r.startswith("paper_")]
    assert [r for r in got if r.startswith("paper_")] == [
        r.replace(",0.0,", ",0.000,") for r in paper]


def test_card_sizes_pass_the_l2():
    """At scale 1 Table III leads with the paper's 16 KB row, and each of
    Table VI's arrays holds about 64 MiB, past the card's 50 MB L2."""
    assert access.COPY_BN[0] * 4 == 16 * 1024 == access.SIDE * 4
    for w, _ in access.WIDTHS:
        h = access.layout_rows(w)
        assert h % 128 == 0 and 0.95 * 2**26 < h * w * 4 <= 2**26
        assert access.layout_rows(w, 4) * w * 4 <= 2**22


def test_without_device_cpu_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.access", "--table", "5"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "cuda" in res.stderr and "replicated_x" not in res.stdout
