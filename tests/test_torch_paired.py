"""`tools.paired`: the seed-by-seed pairing of two layer-3 banks and the
paired gate, on the committed banks and on made-up ones."""

import math
import os

import pytest

import chip_c2
from hybridquantization_tpu_torch.tools import paired

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVIDENCE = os.path.join(REPO, "docs", "evidence")
C2 = os.path.join(REPO, "docs", "evidence_h100", "c2")


def _bank(values):
    return {s: {"seed": s, "deltaE": v} for s, v in enumerate(values)}


def test_reproduces_the_committed_config1nat_fp32_pairing():
    p = paired.pair(paired.load(os.path.join(C2, "draws_config1nat_fp32_jax.jsonl")),
                    paired.load(os.path.join(EVIDENCE, "engine_config1nat_r04.jsonl")))
    assert (p.n, p.agree, p.diverged, p.higher) == (96, 40, 56, 30)
    assert round(100 * p.diff / p.mean_b, 2) == 0.52 and round(100 * p.se / p.mean_b, 2) == 0.34
    assert round(p.sign_p, 2) == 0.69 and round(p.r, 3) == 0.841
    assert not p.fault
    text = p.text()
    assert text.startswith("paired over 96 seeds: port 8.8669, JAX 8.8211; difference +0.0458 ± 0.0299 (SE)")
    assert "40/96 seeds within 0.001 relative; diverged 56, port higher on 30: sign-test p 0.69" in text


def test_the_tpu_pairs_with_itself_across_arithmetic():
    """The yardstick: the TPU's highest bank against its f32x3 bank at
    config-1 smooth, the same streams, only the arithmetic changed."""
    p = paired.pair(paired.load(os.path.join(EVIDENCE, "engine_config1_highest_r04.jsonl")),
                    paired.load(os.path.join(EVIDENCE, "engine_config1_r04.jsonl")))
    assert (p.n, p.diverged, p.higher) == (24, 17, 7)
    assert round(100 * p.sd / p.mean_b, 2) == 1.22 and round(100 * p.diff / p.mean_b, 2) == -0.53
    assert not p.fault  # 2.1 SE from zero, but the diverged seeds part both ways


@pytest.mark.parametrize("k, n, p", [(30, 56, 0.6889), (33, 65, 1.0), (0, 5, 0.0625), (5, 5, 0.0625),
                                     (0, 0, 1.0), (7, 17, 0.6291)])
def test_sign_test_is_the_two_sided_binomial(k, n, p):
    assert paired.sign_test(k, n) == pytest.approx(p, abs=1e-4)


@pytest.mark.parametrize("name, a, fault", [
    # every seed higher by 1%: an offset, which both tests see
    ("offset", [10.0 * (1 + 0.01 + 0.001 * (s % 3)) for s in range(24)], True),
    # large tails up on 10 seeds, small steps down on 14: the mean moves, the sign test does not
    ("tails", [10.0 * (1.05 if s < 10 else 0.995) for s in range(24)], False),
    # half up, half down by 2%: chaos with no offset
    ("chaos", [10.0 * (1.02 if s % 2 else 0.98) for s in range(24)], False),
    # the same bank: no difference at all
    ("equal", [10.0] * 24, False),
])
def test_the_gate_needs_both_the_mean_and_the_sign_test(name, a, fault):
    p = paired.pair(_bank(a), _bank([10.0] * 24))
    assert p.fault is fault
    if name == "tails":
        assert p.z > paired.SIGMAS and p.sign_p > paired.SIGN_P
    if name == "equal":
        assert (p.diverged, p.se, p.z, p.sign_p) == (0, 0.0, 0.0, 1.0) and math.isnan(p.r)
        assert "none diverged" in p.text()


def test_few_common_seeds_give_no_pairing():
    assert paired.pair(_bank([1.0, 2.0]), _bank([1.0, 2.0, 3.0])) is None
    assert paired.paired(_bank([1.0, 2.0]), _bank([1.0, 2.0, 3.0])) == "paired: 2 common seeds"


def test_chip_c2_pairs_through_the_module():
    assert chip_c2.paired is paired.paired and chip_c2.load is paired.load


def test_the_command_line_writes_its_line(tmp_path, capsys):
    dest = tmp_path / "paired.txt"
    assert paired.main([os.path.join(EVIDENCE, "engine_config1_highest_r04.jsonl"),
                        os.path.join(EVIDENCE, "engine_config1_r04.jsonl"), "--labels", "highest,f32x3",
                        "--out", str(dest)]) == 0
    line = dest.read_text()
    assert line.startswith("paired over 24 seeds: highest 11.1496, f32x3 11.2095")
    assert line.strip() == capsys.readouterr().out.strip()


@pytest.mark.parametrize("name, a, fault, verdict", [
    ("offset", [10.0 * (1 + 0.01 + 0.001 * (s % 3)) for s in range(24)], True, "port fault"),
    # the tails the TPU-paired gate passes: the mean alone faults the same-function gate
    ("tails", [10.0 * (1.05 if s < 10 else 0.995) for s in range(24)], True, "port fault"),
    # the port higher on 6 of 24 seeds by 0.2%, the rest equal: the mean stays within 2 SE, the sign
    # test over the 6 diverged seeds alone faults
    ("minority", [10.0 * (1.002 + 0.01 * (s == 0) if s < 6 else 1.0) for s in range(24)], True, "port fault"),
    # half up, half down by 2%: no fault, but no seed agrees
    ("chaos", [10.0 * (1.02 if s % 2 else 0.98) for s in range(24)], False, "in between"),
    ("equal", [10.0] * 24, False, "the port is JAX's engine"),
])
def test_the_same_function_gate_needs_either_test(name, a, fault, verdict):
    p = paired.pair(_bank(a), _bank([10.0] * 24))
    assert (p.same_function_fault, p.verdict) == (fault, verdict)
    if name == "tails":
        assert not p.fault
    if name == "minority":
        assert abs(p.z) <= paired.SIGMAS and p.sign_p < paired.SIGN_P


def test_the_committed_xla_banks_pass_the_same_function_gate():
    """The port with JAX's XLA-branch function on JAX's streams against JAX's
    engine of that function off the TPU, seeds 0-23."""
    p = paired.pair(paired.load(os.path.join(C2, "draws_config1nat_xla_jax.jsonl")),
                    paired.load(os.path.join(C2, "jaxcpu_config1nat_xla.jsonl")))
    assert (p.n, p.agree, p.diverged) == (24, 19, 5)
    assert round(100 * p.diff / p.mean_b, 2) == 0.26 and round(100 * p.se / p.mean_b, 2) == 0.45
    assert not p.same_function_fault and p.verdict == "the port is JAX's engine"


def test_the_command_line_gives_the_verdict(capsys):
    bank = os.path.join(C2, "jaxcpu_config1nat_xla.jsonl")
    assert paired.main([bank, bank, "--verdict"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("same-function gate: pass; verdict: the port is JAX's engine (needs >= 0.667")


def test_bit_equal_names_the_seeds_that_differ():
    rerun = paired.load(os.path.join(C2, "draws_config1nat_fp32_jax_rerun.jsonl"))
    bank = paired.load(os.path.join(C2, "draws_config1nat_fp32_jax.jsonl"))
    assert paired.bit_equal(rerun, bank) == "bit-equal (deltaE, mse) on 24 of 24 common seeds; differ: []"
    rerun[3] = {**rerun[3], "mse": rerun[3]["mse"] * (1 + 1e-15)}
    assert paired.bit_equal(rerun, bank).endswith("on 23 of 24 common seeds; differ: [3]")


def test_the_off_tpu_bank_reads_c3():
    """Fault C3: the port's fp32 engine on JAX's streams against JAX's f32
    engine off the TPU at config-1 natural, seeds 0-47 (the read set of the
    rule fixed before the bank was run): 43 agree, the 5 others all end
    lower in the port, and the mean lies 2.13 SE below zero."""
    p = paired.pair(paired.load(os.path.join(C2, "draws_config1nat_fp32_jax.jsonl")),
                    paired.load(os.path.join(C2, "jaxcpu_config1nat_highest.jsonl")))
    assert (p.n, p.agree, p.diverged, p.higher) == (48, 43, 5, 0) and p.seeds == tuple(range(48))
    assert round(p.z, 2) == -2.13 and round(p.sign_p, 4) == 0.0625
    assert p.same_function_fault and not p.fault and p.verdict == "port fault"
