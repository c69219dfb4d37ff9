"""`chip_draws.py`'s anneal on the CPU (the kernels' plain versions) at a tiny
size: its draw sources, the split fitness, and its per-iteration counts."""

import json

import numpy as np
import pytest
import torch

import chip_draws
from hybridquantization_tpu_torch.tools import engine_run

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

SIZE, K, IMAX, POP = 32, 4, 20, 4


def _argv(out, **kw):
    args = {"content": "natural", "size": SIZE, "colors": K, "imax": IMAX, "seeds": "0,1", "out": out,
            **kw}
    return [x for k, v in args.items() for x in (f"--{k}", str(v))]


def _records(path):
    return {r["seed"]: r for r in map(json.loads, open(path))}


def test_device_draws_are_engine_runs_run(tmp_path):
    out = tmp_path / "device.jsonl"
    assert chip_draws.main(_argv(out, draws="device", fitness="fp32"), device="cpu") == 0
    ref = tmp_path / "engine.jsonl"
    assert engine_run.main(["--content", "natural", "--size", str(SIZE), "--colors", str(K), "--imax",
                            str(IMAX), "--seeds", "0,1", "--out", str(ref), "--cpu"]) == 0
    got, want = _records(out), _records(ref)
    for s in (0, 1):
        assert (got[s]["deltaE"], got[s]["mse"]) == (want[s]["deltaE"], want[s]["mse"])
        assert (got[s]["draws"], got[s]["assign"]) == ("device", "fp32")


@pytest.mark.parametrize("fitness", ["fp32", "split"])
def test_counts_leave_the_run_as_it_was(tmp_path, fitness):
    counted, plain = tmp_path / "counted.jsonl", tmp_path / "plain.jsonl"
    counts = tmp_path / "counts.jsonl"
    assert chip_draws.main(_argv(counted, draws="jax", fitness=fitness, counts=counts), device="cpu") == 0
    assert chip_draws.main(_argv(plain, draws="jax", fitness=fitness), device="cpu") == 0
    a, b = _records(counted), _records(plain)
    assert [a[s]["deltaE"] for s in (0, 1)] == [b[s]["deltaE"] for s in (0, 1)]
    assert (a[0]["assign"], a[0]["conv"], a[0]["draws"]) == (fitness, "fp32", "jax")
    series = [json.loads(line) for line in open(counts)]
    assert [r["seed"] for r in series] == [0, 1]
    for r in series:
        acc, up, lost, imp = (np.array(r[k]) for k in chip_draws.COUNTS)
        assert all(len(x) == IMAX for x in (acc, up, lost, imp))
        assert (0 <= up).all() and (up <= acc).all() and (acc <= POP).all()
        assert (0 <= lost).all() and (lost <= POP).all() and set(imp) <= {0, 1}
        assert acc.sum() > 0  # the hot start takes proposals
        assert r["deltaE"] == a[r["seed"]]["deltaE"]


def test_host_draws_run_with_either_fitness(tmp_path):
    """The host's mt19937 draws, with the engine's fitness and the emulated one;
    the records say which ran."""
    fp32, split = tmp_path / "fp32.jsonl", tmp_path / "split.jsonl"
    assert chip_draws.main(_argv(fp32, draws="host", fitness="fp32", seeds="0"), device="cpu") == 0
    assert chip_draws.main(_argv(split, draws="host", fitness="split", seeds="0"), device="cpu") == 0
    assert _records(fp32)[0]["assign"] == "fp32" and _records(split)[0]["assign"] == "split"
    assert np.isfinite(_records(split)[0]["deltaE"])


def test_chip_c2_stages_rehearse_on_the_cpu(tmp_path, monkeypatch, capsys):
    """chip_c2's stages at a tiny size on the CPU: layer 2 with the split
    fitness, the banks with their counts, an oracle run stopped at its
    deadline, and the reports, pairings and counts tables."""
    import time

    import chip_c2

    evidence, out = tmp_path / "evidence", tmp_path / "c2"
    evidence.mkdir()
    out.mkdir()
    cfg = {"size": SIZE, "colors": K, "imax": IMAX, "population": POP, "content": "natural"}
    jax_bank = [{"seed": s, "deltaE": 22.0 + s, "mse": 0.03, **cfg} for s in range(3)]
    (evidence / "jax.jsonl").write_text("".join(json.dumps(r) + "\n" for r in jax_bank))
    (evidence / "oracle.jsonl").write_text(json.dumps({"seed": 0, "deltaE": 23.0, "mse": 0.03, **cfg}) + "\n")
    assert engine_run.main(["--content", "natural", "--size", str(SIZE), "--colors", str(K), "--imax",
                            str(IMAX), "--seeds", "0-1", "--out", str(out / "fp32_full.jsonl"),
                            "--cpu"]) == 0
    monkeypatch.setattr(chip_c2, "EVIDENCE", str(evidence))
    monkeypatch.setattr(chip_c2, "IMAX", IMAX)
    monkeypatch.setattr(chip_c2, "CONFIGS", {
        "config1nat": ("natural", SIZE, K, "jax.jsonl", "oracle.jsonl", 2, "fp32_full.jsonl")})
    monkeypatch.setattr(chip_c2, "LAYER2", (("tiny", "natural", 48, 8),))
    monkeypatch.setattr(chip_c2, "LAYER2_ARGS", ["--palettes", "2", "--cpu"])
    monkeypatch.setattr(chip_c2, "BANKS", (("config1nat", "split", "device", "0-1", "0", ""),
                                           ("config1nat", "fp32", "device", "0-1", "0", ""),
                                           ("config1nat", "fp32", "jax", "0-2", "", ""),
                                           ("config1nat", "fp32", "jax", "3-4", "", "_3-4")))
    chip_c2.layer2(str(out), "cpu")
    runs = chip_c2.start_oracle(str(out), "config1nat:2")
    chip_c2.banks(str(out), time.time() + 600, "cpu")
    chip_c2.stop_oracle(str(out), runs, time.time() + 120)
    chip_c2.reports(str(out))
    text = capsys.readouterr().out
    assert "DETERMINISTIC PARITY:" in (out / "fitness_parity_split_tiny.log").read_text()
    assert sorted(_records(out / "draws_config1nat_split_device.jsonl")) == [0, 1]
    assert sorted(_records(out / "oracle_config1nat.jsonl")) == [0, 1, 2]
    assert "fp32 device reruns equal to the bank bit for bit on 2/2 seeds" in text
    assert "paired over 3 seeds" in (out / "paired_config1nat_fp32_jax.txt").read_text()
    assert "counts_config1nat_split_device.jsonl (1 seeds)" in (out / "counts_config1nat.txt").read_text()
    assert (out / "report_config1nat_split_device_vs_oracle_n3.txt").exists()
    assert sorted(_records(out / "draws_config1nat_fp32_jax_3-4.jsonl")) == [3, 4]
    assert (out / "report_config1nat_fp32_jax_3-4_vs_jax.txt").exists()


def test_chip_c2_layer2_runs_a_fail_again_and_returns_the_verdicts(tmp_path, monkeypatch):
    """A layer-2 log whose verdict is FAIL is run again on resume, a PASS is
    not, and the verdicts come back for chip_c2's exit code."""
    import chip_c2
    from hybridquantization_tpu_torch.tools import tpu_f32x3

    verdicts, calls = iter(["FAIL", "PASS"]), []

    def main(argv, device):
        calls.append(argv)
        v = next(verdicts)
        print(f"DETERMINISTIC PARITY: {v} (tolerance 1e-03, random palettes)")
        return 0 if v == "PASS" else 1

    monkeypatch.setattr(tpu_f32x3, "main", main)
    monkeypatch.setattr(chip_c2, "LAYER2", (("tiny", "natural", 48, 8),))
    first = chip_c2.layer2(str(tmp_path), "cpu")
    assert first["tiny"].startswith("DETERMINISTIC PARITY: FAIL") and not chip_c2._passed(first["tiny"])
    assert chip_c2._passed(chip_c2.layer2(str(tmp_path), "cpu")["tiny"]) and len(calls) == 2
    assert chip_c2._passed(chip_c2.layer2(str(tmp_path), "cpu")["tiny"]) and len(calls) == 2
