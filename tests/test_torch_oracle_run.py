"""`tools.oracle_run` (the oracle's own seeds, without jax) at a tiny size:
its records against `oracle.swasa_search` and the judge called directly, the
resume, the heartbeats, and the frozen `tools/parity_report.py` reading the
file."""

import glob
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hybridquantization_tpu_torch.tools import oracle_run
from hybridquantization_tpu_torch.tools.parity_check import content_image
from tests import oracle

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

REPO = Path(__file__).resolve().parents[1]
SIZE, COLORS, IMAX, POP = 32, 4, 20, 4
KEYS = ["seed", "deltaE", "mse", "search_fitness", "dtype", "size", "colors", "imax", "population",
        "content", "seconds"]


def _argv(out, seeds):
    return ["--content", "natural", "--size", str(SIZE), "--colors", str(COLORS), "--imax", str(IMAX),
            "--population", str(POP), "--seeds", seeds, "--jobs", "2", "--dtype", "f32", "--out", str(out)]


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _direct(seed):
    """The oracle's search and the f64 judge, called here (the JAX tool's judge)."""
    img = content_image("natural", SIZE)
    ofilters, abs_k3, _ = oracle.build_filters(72, 45.0)
    target = oracle.srgb_to_scielab(img.astype(np.float64), ofilters, abs_k3)
    pal, err = oracle.swasa_search(img.astype(np.float32), COLORS, seed=seed, population=POP, imax=IMAX,
                                   dtype=np.float32)
    pal = np.asarray(pal, np.float64)
    q = pal[oracle.nearest_palette(img.reshape(-1, 3).astype(np.float64), pal)].reshape(img.shape)
    de = float(oracle.delta_e76(target, oracle.srgb_to_scielab(q, ofilters, abs_k3)).mean())
    return de, float(((q - img) ** 2).mean()), float(err)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle") / "oracle.jsonl"
    assert oracle_run.main(_argv(out, "0,1")) == 0
    return out


def test_records_equal_the_oracle_called_directly(bank):
    recs = sorted(_records(bank), key=lambda r: r["seed"])
    assert [r["seed"] for r in recs] == [0, 1]
    for r in recs:
        assert list(r) == KEYS
        assert (r["dtype"], r["size"], r["colors"], r["imax"], r["population"], r["content"]) == (
            "f32", SIZE, COLORS, IMAX, POP, "natural")
        assert (r["deltaE"], r["mse"], r["search_fitness"]) == _direct(r["seed"])


def test_workers_heartbeat(bank):
    beats = glob.glob(f"{bank}.hb.*")
    assert len(beats) == 2
    for b in beats:
        assert f" iter 0/{IMAX} " in open(b).read()


def test_rerun_skips_the_done_seeds(bank, tmp_path, capsys):
    out = tmp_path / "resumed.jsonl"
    out.write_text(bank.read_text())
    assert oracle_run.main(_argv(out, "0,1")) == 0
    assert "seeds todo []" in capsys.readouterr().out
    assert oracle_run.main(_argv(out, "0-2")) == 0
    recs = _records(out)  # the workers append in the order they finish
    assert sorted(r["seed"] for r in recs) == [0, 1, 2] and recs[2]["seed"] == 2
    assert recs[:2] == _records(bank)


def test_frozen_parity_report_reads_the_bank(bank):
    r = subprocess.run([sys.executable, str(REPO / "tools" / "parity_report.py"), "--engine", str(bank),
                        "--oracle", str(bank)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode in (0, 1), r.stderr
    assert "PARITY:" in r.stdout and "n=2" in r.stdout


def test_sigterm_ends_the_workers(tmp_path):
    """A timeout's SIGTERM ends the spawned workers with the tool."""
    import os
    import signal
    import time

    out = tmp_path / "long.jsonl"
    argv = _argv(out, "0,1")
    argv[argv.index("--imax") + 1] = "100000"
    proc = subprocess.Popen([sys.executable, "-m", "hybridquantization_tpu_torch.tools.oracle_run", *argv],
                            cwd=REPO)
    deadline = time.time() + 60
    while len(glob.glob(f"{out}.hb.*")) < 2 and time.time() < deadline:
        time.sleep(0.2)
    pids = [int(b.rsplit(".", 1)[1]) for b in glob.glob(f"{out}.hb.*")]
    assert len(pids) == 2
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 128 + signal.SIGTERM
    deadline = time.time() + 10
    alive = pids
    while alive and time.time() < deadline:
        alive = [p for p in alive if os.path.exists(f"/proc/{p}")]
        time.sleep(0.1)
    assert not alive
