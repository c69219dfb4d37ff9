"""`chip_draws.py`'s anneal on the CPU (the kernels' plain versions) at a tiny
size: its draw sources, the split fitness, and its per-iteration counts."""

import json
import os

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


def test_modes_and_series_on_the_cpu_flag(tmp_path):
    """`--cpu` with the LAB space and bf16 scores: the records name the mode
    as engine_run's do, and `--series` holds imax best errors that fall and
    end at the run's best error, find_palette's own with the same draws."""
    from hybridquantization_tpu_torch import HybridQuantizer, QuantizationConfig, SWASAConfig
    from hybridquantization_tpu_torch.tools.parity_check import content_image

    imax = 3
    out, series, ref = tmp_path / "lab.jsonl", tmp_path / "series.jsonl", tmp_path / "engine.jsonl"
    argv = _argv(out, draws="device", imax=imax, seeds="0", space="lab", precision="bf16", series=series)
    assert chip_draws.main([*argv, "--cpu"]) == 0
    rec = _records(out)[0]
    assert (rec["precision"], rec["assignment_space"], rec["assign"], rec["conv"], rec["device"]) == (
        "bf16", "lab", "bf16", "bf16", "cpu")
    assert engine_run.main(["--content", "natural", "--size", str(SIZE), "--colors", str(K), "--imax",
                            str(imax), "--seeds", "0", "--precision", "bf16", "--assignment-space", "lab",
                            "--out", str(ref), "--cpu"]) == 0
    assert (rec["deltaE"], rec["mse"]) == (_records(ref)[0]["deltaE"], _records(ref)[0]["mse"])
    (line,) = [json.loads(x) for x in open(series)]
    best = line["best_error"]
    assert len(best) == imax and best == sorted(best, reverse=True) and line["deltaE"] == rec["deltaE"]
    cfg = QuantizationConfig(swasa=SWASAConfig(num_colors=K, population=POP, imax=imax), precision="bf16",
                             assignment_space="lab")
    _, info = HybridQuantizer(cfg, device="cpu").find_palette(
        content_image("natural", SIZE), generator=torch.Generator().manual_seed(0), chunk_size=imax)
    assert best == np.asarray(info["telemetry"]["best_error"], np.float32).tolist()
    assert best[-1] == np.float32(info["best_error"])


@pytest.mark.parametrize("flags", [["--space", "lab"], ["--precision", "bf16"], ["--conv-precision", "bf16"]])
def test_the_emulated_fitness_refuses_other_modes(flags):
    with pytest.raises(SystemExit):
        chip_draws.parse_args(["--fitness", "split", *flags])


def test_chip_parity_rehearses_a_row_with_no_oracle_bank(tmp_path, monkeypatch, capsys):
    """chip_parity's layer 3 and reports on the CPU with a shrunk table: a
    LAB row with no oracle bank gets its card bank, its JAX-stream bank, the
    frozen report against JAX only and the paired report; a made-up JAX bank
    1% under the port on all 6 seeds is a paired fault, one equal to the
    port's JAX-stream bank is not."""
    import chip_parity

    evidence, out = tmp_path / "evidence", tmp_path / "out"
    evidence.mkdir()
    out.mkdir()
    imax = 3
    monkeypatch.setattr(chip_parity, "EVIDENCE", str(evidence))
    monkeypatch.setattr(chip_parity, "LAYER3_ARGS", ["--imax", str(imax)])
    row = chip_parity.Row("tiny_lab", "natural", SIZE, K, "0-1", None, "jax.jsonl", "draws_tiny_lab_jax.jsonl",
                          "0-5", space="lab")
    chip_parity.layer3(str(out), "cpu", (row,))
    port = _records(out / "engine_tiny_lab.jsonl")
    stream = _records(out / row.paired)
    assert (sorted(port), sorted(stream)) == ([0, 1], [0, 1, 2, 3, 4, 5])
    assert {r["assignment_space"] for r in (*port.values(), *stream.values())} == {"lab"}
    cfg = {"size": SIZE, "colors": K, "imax": imax, "population": POP, "content": "natural", "precision": "f32x3",
           "assignment_space": "lab"}
    for scale, fault in ((1.0, False), (0.99, True)):
        jax_bank = [{**cfg, "seed": s, "deltaE": r["deltaE"] * scale * (1 + 1e-4 * s), "mse": r["mse"]}
                    for s, r in stream.items()]
        (evidence / "jax.jsonl").write_text("".join(json.dumps(r) + "\n" for r in jax_bank))
        faults = chip_parity.reports(str(out), (row,))
        assert (out / "report_tiny_lab_vs_jax.txt").exists()
        assert not (out / "report_tiny_lab_vs_oracle.txt").exists()
        text = (out / "paired_tiny_lab_vs_jax.txt").read_text()
        assert text.startswith("draws_tiny_lab_jax.jsonl against jax.jsonl: paired over 6 seeds")
        assert any(f.startswith("tiny_lab paired: ") for f in faults) is fault
    assert "[paired] tiny_lab" in capsys.readouterr().out


def test_chip_parity_selects_its_rows():
    import chip_parity

    assert [r.name for r in chip_parity.select("config1_lab,config2nat")] == ["config2nat", "config1_lab"]
    assert len(chip_parity.select("")) == len(chip_parity.LAYER3) == 9
    with pytest.raises(SystemExit):
        chip_parity.select("config9")


def test_the_xla_fitness_runs_and_is_recorded(tmp_path):
    """`--fitness xla` (JAX's fitness off the TPU, emulated) anneals on the
    CPU and records its arithmetic; it takes the default mode only."""
    out = tmp_path / "xla.jsonl"
    assert chip_draws.main([*_argv(out, draws="jax", imax=3, seeds="0", fitness="xla"), "--cpu"]) == 0
    rec = _records(out)[0]
    assert (rec["assign"], rec["conv"], rec["draws"]) == ("xla", "fp32", "jax") and np.isfinite(rec["deltaE"])
    with pytest.raises(SystemExit):
        chip_draws.parse_args(["--fitness", "xla", "--space", "lab"])


def test_chip_parity_highest_row_reads_config1_banks():
    """The "highest" row anneals nothing of its own: chosen alone or beside
    config-1 it runs config-1's two banks once and reports them."""
    import chip_parity

    (highest,) = chip_parity.select("config1_highest")
    assert chip_parity.owners((highest,)) == (chip_parity.CONFIG1,)
    assert chip_parity.owners(chip_parity.select("config1,config1_highest")) == (chip_parity.CONFIG1,)
    assert chip_parity.card_bank("out", highest) == chip_parity.card_bank("out", chip_parity.CONFIG1)
    assert (highest.paired, highest.oracle, highest.jax) == (
        chip_parity.CONFIG1.paired, None, "engine_config1_highest_r04.jsonl")


@pytest.mark.parametrize("name, scale, fault", [
    ("equal", lambda s: 1.0, False),
    # the port 5% worse on 10 of 24 seeds, 0.5% better on 14 (test_torch_paired.py's tails): the
    # TPU-paired gate passes it, the off-TPU gate does not
    ("tails", lambda s: 1 / 1.05 if s < 10 else 1 / 0.995, True),
    # half the seeds 2% up, half 2% down: no offset, no sign
    ("chaos", lambda s: 1.02 if s % 2 else 0.98, False),
])
def test_chip_parity_reports_the_off_tpu_pairing(tmp_path, name, scale, fault):
    """`reports` on the committed config-1 natural banks with a made-up
    off-TPU JAX bank (seeds 0-23): the third pairing is written, a `jax-cpu`
    fault comes exactly when the same-function gate fails, and the
    unpaired gate's fault and JAX_GAP stay as they were."""
    import shutil

    import chip_parity
    from hybridquantization_tpu_torch.tools import paired

    (row,) = chip_parity.select("config1nat")
    assert row.jax_cpu == os.path.join("c2", "jaxcpu_config1nat_highest.jsonl") and chip_parity.JAX_GAP == 0.01
    out = tmp_path / "out"
    (out / "c2").mkdir(parents=True)
    shutil.copy(os.path.join(chip_parity.EVIDENCE_H100, "engine_config1nat.jsonl"), out)
    shutil.copy(os.path.join(chip_parity.EVIDENCE_H100, row.paired), out / "c2")
    stream = _records(out / row.paired)
    stub = tmp_path / "jaxcpu.jsonl"
    stub.write_text("".join(json.dumps({**stream[s], "deltaE": stream[s]["deltaE"] * scale(s)}) + "\n"
                            for s in range(24)))
    faults = chip_parity.reports(str(out), (row._replace(jax_cpu=str(stub)),))
    assert faults[0] == "config1nat: Delta-E gap to the JAX engine +2.31% ± 0.91%"
    assert not any(f.startswith("config1nat paired") for f in faults)
    text = (out / "paired_config1nat_vs_jaxcpu.txt").read_text()
    assert text.startswith(f"{row.paired} against {stub}: paired over 24 seeds: port ")
    p = paired.pair(stream, _records(stub))
    assert p.same_function_fault is fault and not p.fault
    assert any(f.startswith("config1nat jax-cpu: ") for f in faults) is fault
    assert ("verdict: port fault" in text) is fault


def test_chip_parity_off_tpu_gate_reads_the_0_47_bank_at_unchanged_thresholds():
    """The config-1 natural row's off-TPU gate reads JAX's bank of seeds
    0-47 (fault C3's first read set), not the fresh 48-95 bank beside it,
    and the three gates' thresholds are those the verdicts were read by."""
    import chip_parity
    from hybridquantization_tpu_torch.tools import paired

    (row,) = chip_parity.select("config1nat")
    assert row.jax_cpu == os.path.join("c2", "jaxcpu_config1nat_highest.jsonl")
    path = os.path.join(chip_parity.EVIDENCE_H100, row.jax_cpu)
    assert sorted(_records(path)) == list(range(48))
    assert [r.name for r in chip_parity.LAYER3 if r.jax_cpu] == ["config1nat"]
    assert chip_parity.JAX_GAP == 0.01  # the unpaired gate
    assert (paired.SIGMAS, paired.SIGN_P) == (2.0, 0.05)  # the paired and the same-function gates
    assert (paired.PAIR_REL, paired.AGREE_SHARE) == (1e-3, 2 / 3)  # the same-function verdict
