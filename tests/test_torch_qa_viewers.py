"""The port's QA viewers (`rgbdseg_torch/tools/qa_viewers.py`) on the CPU: the
intermediates they return equal the JAX ops' bit for bit (`csf_intermediates`,
`depth_histogram` and `select_modes`, `dsam_region_masks`; the JAX viewers
themselves draw with matplotlib), as `tests/test_torch_versions_ops.py` and
`tests/test_torch_modules.py` hold those ops, and the panels they write decode
with `image_io.read_png` at their expected sizes, also through the CLI."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgbdseg_tpu.ops import csf as jcsf
from rgbdseg_tpu.ops import depth_decomp as JD
from rgbdseg_torch.data.image_io import read_png, write_png
from rgbdseg_torch.tools import qa_viewers as Q

GAP = Q.GAP


def _depth(seed: int = 0, h: int = 30, w: int = 40) -> np.ndarray:
    """Three depth modes and a uniform floor, 8-bit levels as a gray PNG holds them."""
    rng = np.random.RandomState(seed)
    n = h * w
    d = np.concatenate([rng.normal(40, 3, n // 3), rng.normal(120, 5, n // 3), rng.normal(200, 4, n // 6),
                        rng.uniform(0, 255, n - n // 3 * 2 - n // 6)])
    rng.shuffle(d)
    return np.clip(np.round(d), 0, 255).reshape(h, w).astype(np.float32)


def _frames(n: int = 4, h: int = 12, w: int = 16) -> np.ndarray:
    return np.random.RandomState(1).randint(0, 256, (n, h, w, 1)).astype(np.float32)


def test_csf_viewer_matches_jax(tmp_path):
    imgs = _frames()
    got = Q.csf_viewer(imgs, save=str(tmp_path / "csf.png"), device="cpu")
    ref = jcsf.csf_intermediates(jnp.asarray(imgs))
    for key in ("sim", "best", "round_images", "counts", "scores", "weights", "fused"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    n, h, w = imgs.shape[:3]
    png = read_png(str(tmp_path / "csf.png"))
    assert png.shape == (n * (h + GAP) - GAP, (n + 1) * (w + GAP) - GAP, 3)
    np.testing.assert_array_equal(png, got["image"])


@pytest.mark.parametrize("seed", [0, 1])
def test_dsam_viewers_match_jax(tmp_path, seed):
    depth = _depth(seed)
    hist = Q.dsam_histogram_viewer(depth, ratio=0.2, bins=128, save=str(tmp_path / "hist.png"), device="cpu")
    jh, jlo, jw = JD.depth_histogram(jnp.asarray(depth), 128)
    jc, jv = JD.select_modes(jh, jlo, jw, 3)
    np.testing.assert_array_equal(hist["hist"], np.asarray(jh))
    assert float(hist["lo"]) == float(jlo) and float(hist["width"]) == float(jw)
    np.testing.assert_array_equal(hist["centers"], np.asarray(jc))
    np.testing.assert_array_equal(hist["valid"], np.asarray(jv))
    assert hist["valid"].sum() == 3
    assert read_png(str(tmp_path / "hist.png")).shape == (200, 128, 3)

    regions = Q.dsam_region_viewer(depth, ratio=0.2, save=str(tmp_path / "regions.png"), device="cpu")
    jm, ja = JD.dsam_region_masks(jnp.asarray(depth)[None], jnp.asarray([0.2], jnp.float32))
    np.testing.assert_array_equal(regions["masks"], np.asarray(jm[0]))
    np.testing.assert_array_equal(regions["active"], np.asarray(ja[0]))
    t1 = regions["masks"].shape[0]
    h, w = depth.shape
    assert read_png(str(tmp_path / "regions.png")).shape == (h, (t1 + 1) * (w + GAP) - GAP, 3)


def test_jet_table_ends_and_cli(tmp_path):
    """The table runs from matplotlib jet's dark blue to its dark red; the CLI
    reads gray PNGs and writes the three panels."""
    assert Q.JET.shape == (256, 3)
    np.testing.assert_array_equal(Q.JET[0], [0, 0, 128])
    np.testing.assert_array_equal(Q.JET[-1], [128, 0, 0])
    paths = []
    for i, f in enumerate(_frames(3)):
        paths.append(str(tmp_path / f"m{i}.png"))
        write_png(paths[-1], f[..., 0].astype(np.uint8))
    write_png(str(tmp_path / "d.png"), _depth().astype(np.uint8))
    Q.main(["--device", "cpu", "csf", "--images", *paths, "--save", str(tmp_path / "c.png")])
    Q.main(["--device", "cpu", "dsam", "--depth", str(tmp_path / "d.png"), "--save_hist", str(tmp_path / "h.png"),
            "--save_regions", str(tmp_path / "r.png")])
    assert read_png(str(tmp_path / "c.png")).shape == (3 * (12 + GAP) - GAP, 4 * (16 + GAP) - GAP, 3)
    assert read_png(str(tmp_path / "h.png")).shape == (200, 512, 3)
    assert read_png(str(tmp_path / "r.png")).shape[0] == 30
