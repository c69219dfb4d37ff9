"""The torch port's CLI (`python -m hybridquantization_tpu_torch.cli`) on the
CPU, through `main(argv, device="cpu")`, on `.ppm` files (no PIL needed), and
its `error` command against the JAX CLI's."""

import json
import re

import numpy as np
import pytest
import torch

from hybridquantization_tpu.cli import main as jmain
from hybridquantization_tpu_torch import io as tio
from hybridquantization_tpu_torch.cli import main
from hybridquantization_tpu_torch.synth import natural_image

torch.set_num_threads(1)  # one intra-op thread: see test_torch_colorspace.py

DE_RTOL = 1e-5  # one f32 S-CIELAB pass on each side of the same two files


@pytest.fixture()
def ppm(tmp_path):
    p = tmp_path / "in.ppm"
    tio.save_image(str(p), natural_image(40, 48, seed=2))
    return p


def _delta_e(text):
    return float(re.findall(r"DeltaE : (\S+)", text)[-1])


def test_quantize_with_every_flag(ppm, tmp_path, capsys):
    out, err, pal, ck = (tmp_path / n for n in ("out.ppm", "err.ppm", "pal.npy", "ck.npz"))
    argv = [
        "quantize", str(ppm), str(out), "-k", "6", "--imax", "12", "--population", "3",
        "--init", "kmeans", "--polish", "4", "--dither", "0.5", "--assignment-space", "lab",
        "--checkpoint", str(ck), "--checkpoint-every", "5", "--error-image", str(err),
        "--palette-out", str(pal), "--delta-e", "CIE94", "--seed", "3", "--verbose",
        "--profile", str(tmp_path / "prof"),
    ]
    assert main(argv, device="cpu") == 0
    text = capsys.readouterr().out
    assert "image 48x40, K=6" in text and "polished palette with 4 Lloyd steps" in text
    assert "Final error" in text and np.isfinite(_delta_e(text))
    img = tio.load_image(str(out))
    assert img.shape == (40, 48, 3)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) <= 6
    assert np.load(pal).shape == (6, 3)
    assert tio.load_image(str(err)).shape == (40, 48, 3)
    assert ck.exists()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]

    # a second run resumes from the checkpoint and runs no iteration
    assert main(argv[:-2], device="cpu") == 0
    text = capsys.readouterr().out
    assert "resuming from" in text and "at iteration 12" in text


def test_error_on_mismatched_sizes_exits_2(ppm, tmp_path, capsys):
    other = tmp_path / "other.ppm"
    tio.save_image(str(other), natural_image(16, 16, seed=1))
    assert main(["error", str(ppm), str(other), "--out", str(tmp_path / "e.ppm")], device="cpu") == 2
    assert "Mismatching image sizes, abort." in capsys.readouterr().err


def test_error_matches_the_jax_cli(ppm, tmp_path, capsys):
    quant = tmp_path / "q.ppm"
    tio.save_image(str(quant), np.round(natural_image(40, 48, seed=2) * 4) / 4)
    assert jmain(["error", str(ppm), str(quant), "--out", str(tmp_path / "je.ppm")]) == 0
    want = _delta_e(capsys.readouterr().out)
    assert main(["error", str(ppm), str(quant), "--out", str(tmp_path / "e.ppm")], device="cpu") == 0
    got = _delta_e(capsys.readouterr().out)
    assert got == pytest.approx(want, rel=DE_RTOL)
    np.testing.assert_allclose(
        tio.load_image(str(tmp_path / "e.ppm")), tio.load_image(str(tmp_path / "je.ppm")), atol=1 / 255
    )


@pytest.mark.parametrize(
    "argv,device,message",
    [
        (["quantize-batch", "a.ppm", "b.ppm", "--mesh-data", "2"], "cuda",
         "nccl needs one card per rank: 2 ranks on this host, 0 cards"),
        (["quantize-batch", "a.ppm", "--fast", "--distributed", "--num-processes", "1",
          "--process-id", "0", "--mesh-pixel", "2"], "cpu",
         "mesh 1x1x2 needs 2 ranks on a host, have 1"),
        (["quantize-batch", "a.ppm", "b.ppm", "--mesh-pixel", "8", "--mesh-pop", "2"], "cuda",
         "nccl needs one card per rank: 16 ranks on this host, 0 cards"),
        (["quantize-batch", "a.ppm", "--precision", "bf16", "--mesh-pop", "4"], "cuda",
         "nccl needs one card per rank: 4 ranks on this host, 0 cards"),
    ],
)
def test_unported_commands_raise(argv, device, message, tmp_path):
    """quantize-batch refuses only what cannot run: a mesh larger than the
    group (here a one-rank --distributed job), and NCCL ranks beyond the
    cards of a host (this machine has none). The mesh flags themselves run
    (tests/test_torch_batch.py)."""
    import torch.distributed as dist

    if torch.cuda.device_count():
        pytest.skip("a CUDA device is present")
    extra = ["--coordinator", f"file://{tmp_path}/rendezvous"] if "--distributed" in argv else []
    try:
        with pytest.raises(ValueError, match=re.escape(message)):
            main(argv + extra + ["--out-dir", str(tmp_path)], device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_default_device_is_the_card(ppm, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["error", str(ppm), str(ppm), "--out", str(tmp_path / "e.ppm")])
