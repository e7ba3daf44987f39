"""The port's per-frame and figure tools against the JAX package's, bit for
bit, on the CPU (`rgbdseg_torch/tools/{realsense/*,mask_check,plot_logs}.py`
and `predict_torch.py --compare` against `rgbdseg_tpu/tools/`, which run cv2
and matplotlib).

- The six enhancements, `do_depth_image_process` and the JET / BONE tables on
  odd sizes (CLAHE pads), 480x640 and constant images, over swept parameters.
- `checkout` (saving every frame, and the stdin key loop) and `recorder` with
  one fake `pyrealsense2` module given to both packages: equal files.
- `visualize_masks` / `label_check` with and without a resize.
- `plot_logs`: the series and category keys, the file names and count.
- `predict_torch.py --compare` writes its grids without matplotlib.
"""

import io
import json
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch

import predict_torch
from rgbdseg_tpu.tools import mask_check as JM
from rgbdseg_tpu.tools import plot_logs as JPL
from rgbdseg_tpu.tools.realsense import depth_enhance as JE
from rgbdseg_tpu.tools.realsense import display as JDS
from rgbdseg_tpu.tools.realsense import recorder as JR
from rgbdseg_torch.data.image_io import read_png
from rgbdseg_torch.inference import rle
from rgbdseg_torch.inference.visualize import TITLE_H, PANEL_GAP
from rgbdseg_torch.tools import mask_check as TM
from rgbdseg_torch.tools import plot_logs as TPL
from rgbdseg_torch.tools.realsense import depth_enhance as TE
from rgbdseg_torch.tools.realsense import display as TDS
from rgbdseg_torch.tools.realsense import recorder as TR


def _gray(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "constant":
        return np.full((h, w), rng.randint(0, 256), np.uint8)
    if kind == "narrow":  # a few levels: equalizeHist's first bin and CLAHE's clipping matter
        return (rng.randint(0, 4, (h, w)) * 37 + 90).astype(np.uint8)
    return rng.randint(0, 256, (h, w)).astype(np.uint8)


def _u8(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@pytest.mark.parametrize("kind", ["random", "narrow", "constant"])
@pytest.mark.parametrize("h,w", [(37, 53), (64, 80), (480, 640)])
def test_enhancements_equal_cv2(kind, h, w):
    img = _gray(kind, h, w, h + w)
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(_u8(TE.hist_equalize(t)), JE.hist_equalize(img))
    for clip, tile in ((2.0, 8), (0.5, 3), (6.0, 5), (40.0, 1)):
        np.testing.assert_array_equal(_u8(TE.adaptive_hist_equalize(t, clip, tile)),
                                      JE.adaptive_hist_equalize(img, clip, tile), err_msg=f"CLAHE {clip} {tile}")
    for alpha, beta in ((1.5, 0.0), (-1.3, 10.5), (0.7, -20.25), (2.0, -300.0), (0.33, 1e-7), (1e10, 0.0)):
        np.testing.assert_array_equal(_u8(TE.linear_transform(t, alpha, beta)), JE.linear_transform(img, alpha, beta),
                                      err_msg=f"convertScaleAbs {alpha} {beta}")
    for gamma in (0.3, 0.5, 2.2):
        np.testing.assert_array_equal(_u8(TE.gamma_transform(t, gamma)), JE.gamma_transform(img, gamma))
    np.testing.assert_array_equal(_u8(TE.laplacian_sharpen(t)), JE.laplacian_sharpen(img))
    for ksize in (3, 5, 7):
        for weight in (1.0, 0.5, 2.7, -1.0):
            np.testing.assert_array_equal(_u8(TE.gaussian_subtract(t, ksize, weight)),
                                          JE.gaussian_subtract(img, ksize, weight), err_msg=f"{ksize} {weight}")


def test_convert_scale_abs_rounds_the_fused_multiply_add_once():
    """cv2 fuses x * alpha + beta: seeded parameters where one rounding and two
    roundings give other bytes."""
    rng = np.random.RandomState(0)
    x = np.arange(256, dtype=np.uint8)[None]
    differ = 0
    for _ in range(400):
        alpha = float(np.float32(rng.randint(-80, 80) / rng.choice([3.0, 7.0, 10.0])))
        beta = float(np.float32(rng.randint(-200, 200) / rng.choice([2.0, 3.0, 10.0])))
        two = np.clip(np.rint(np.abs(x.astype(np.float32) * np.float32(alpha) + np.float32(beta))), 0, 255)
        want = cv2.convertScaleAbs(x, alpha=alpha, beta=beta)
        differ += not np.array_equal(two, want)
        np.testing.assert_array_equal(_u8(TE.convert_scale_abs(torch.from_numpy(x), alpha, beta)), want)
    assert differ > 0
    depth = np.random.RandomState(1).randint(0, 65536, (31, 45)).astype(np.uint16)
    np.testing.assert_array_equal(_u8(TE.convert_scale_abs(TE.u16_to_device(depth, "cpu"), 0.03)),
                                  cv2.convertScaleAbs(depth, alpha=0.03))


def test_colormaps_equal_cv2():
    levels = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(TE.COLORMAP_JET[None], cv2.applyColorMap(levels, cv2.COLORMAP_JET))
    np.testing.assert_array_equal(TE.COLORMAP_BONE[None], cv2.applyColorMap(levels, cv2.COLORMAP_BONE))


def _depth_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A z16 frame: a 300-5000 mm ramp, noise, ~5% holes."""
    rng = np.random.RandomState(seed)
    d = np.linspace(300, 5000, w)[None, :] + rng.normal(0, 40, (h, w))
    d[rng.rand(h, w) < 0.05] = 0
    return np.clip(d, 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("h,w", [(37, 53), (120, 160)])
def test_depth_image_process_equals_jax(h, w):
    depth = _depth_frame(h, w, h)
    got, want = TDS.do_depth_image_process(depth, "cpu"), JDS.do_depth_image_process(depth)
    assert got.keys() == want.keys() and len(got) == 8
    for k in want:
        np.testing.assert_array_equal(_u8(got[k]), want[k], err_msg=k)


class _Frame:
    def __init__(self, data):
        self.data = data

    def get_data(self):
        return self.data

    def __bool__(self):
        return True


def _fake_realsense(n_frames: int, h: int = 24, w: int = 32, stop_after=None):
    """A pyrealsense2 stand-in: a pipeline that plays `n_frames` seeded frames
    (BGR colour, z16 depth) and then times out, or, with `stop_after`, replays
    them until a KeyboardInterrupt after that many; filters that decimate,
    shift and copy; a config that records the bag paths it is given."""
    rs = types.ModuleType("pyrealsense2")
    rng = np.random.RandomState(9)
    rs.frames = [(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), _depth_frame(h, w, i)) for i in range(n_frames)]
    rs.bags = []
    frames = rs.frames

    class Frames:
        def __init__(self, i):
            self.i = i

        def get_depth_frame(self):
            return _Frame(frames[self.i][1])

        def get_color_frame(self):
            return _Frame(frames[self.i][0])

    class Pipeline:
        served = 0

        def start(self, config):
            self.i = 0

        def stop(self):
            pass

        def wait_for_frames(self, timeout_ms=None):
            if stop_after is not None and Pipeline.served >= stop_after:
                raise KeyboardInterrupt
            if stop_after is None and self.i >= n_frames:
                raise RuntimeError("Frame didn't arrive within 1000")
            self.i += 1
            Pipeline.served += 1
            return Frames((self.i - 1) % n_frames)

    class Config:
        def enable_device_from_file(self, path, repeat_playback=True):
            pass

        def enable_stream(self, *a):
            pass

        def enable_record_to_file(self, path):
            rs.bags.append(os.path.basename(path))
            open(path, "wb").close()

    class Filter:
        def __init__(self, fn):
            self.fn = fn

        def set_option(self, *a):
            pass

        def process(self, frame):
            return _Frame(self.fn(frame.get_data()))

    rs.pipeline, rs.config = Pipeline, Config
    rs.decimation_filter = lambda: Filter(lambda d: d[::2, ::2].copy())
    rs.spatial_filter = lambda: Filter(lambda d: (d + 1).astype(np.uint16))
    rs.hole_filling_filter = lambda: Filter(lambda d: d.copy())
    rs.option = types.SimpleNamespace(filter_magnitude=0)
    rs.stream = types.SimpleNamespace(depth=0, color=1)
    rs.format = types.SimpleNamespace(z16=0, bgr8=1)
    return rs


def _tree(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, files in os.walk(root) for f in files}


def _same_files(ours, theirs, names=None) -> None:
    a, b = _tree(ours), _tree(theirs)
    names = sorted(b) if names is None else names
    assert sorted(n for n in a if not n.startswith("_preview")) == names
    for n in names:
        if n.endswith(".npy"):
            x, y = np.load(a[n]), np.load(b[n])
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=n)
        elif n.endswith(".png"):
            x, y = cv2.imread(a[n], cv2.IMREAD_UNCHANGED), cv2.imread(b[n], cv2.IMREAD_UNCHANGED)
            assert x.dtype == y.dtype, n
            np.testing.assert_array_equal(x, y, err_msg=n)


def test_checkout_saves_the_jax_tools_files(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense(3))
    assert JDS.checkout("x.bag", str(tmp_path / "jax"), interactive=False) == 3
    monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense(3))
    assert TDS.checkout("x.bag", str(tmp_path / "torch"), interactive=False, device="cpu") == 3
    _same_files(tmp_path / "torch", tmp_path / "jax")
    assert len(_tree(tmp_path / "jax")) == 3 * 13 * 2  # colour, raw depth and 11 derived modalities, PNG + NPY
    # the key loop: next, save (frame 1), previous, save (frame 0), quit
    monkeypatch.setitem(sys.modules, "pyrealsense2", _fake_realsense(3))
    keys = io.StringIO("d\ns\na\ns\nq\n")
    assert TDS.checkout("x.bag", str(tmp_path / "keys"), device="cpu", keys=keys) == 2
    names = sorted(n for n in _tree(tmp_path / "jax") if os.path.basename(n).split(".")[0] in ("0", "1"))
    _same_files(tmp_path / "keys", tmp_path / "jax", names)
    preview = cv2.imread(str(tmp_path / "keys" / "_preview.png"))
    np.testing.assert_array_equal(preview, np.load(tmp_path / "jax" / "color" / "0.npy"))


def test_recorder_writes_the_jax_tools_bags_and_a_preview(tmp_path, monkeypatch):
    rs = _fake_realsense(4, stop_after=10)
    monkeypatch.setitem(sys.modules, "pyrealsense2", rs)
    JR.recorder(str(tmp_path / "jax"), interval=1e9)
    want = list(rs.bags)
    rs = _fake_realsense(4, stop_after=10)
    monkeypatch.setitem(sys.modules, "pyrealsense2", rs)
    TR.recorder(str(tmp_path / "torch"), interval=1e9, preview=True, device="cpu")
    assert rs.bags == want == ["record_0000.bag"]
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax") + ["_preview.png"])
    c, d = rs.frames[(10 - 1) % 4]  # the last frame served before the interrupt
    want = np.hstack([c, cv2.applyColorMap(cv2.convertScaleAbs(d, alpha=0.03), cv2.COLORMAP_JET)])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "torch" / "_preview.png")), want)


def _mask_set(root, resize: bool):
    rng = np.random.RandomState(int(resize))
    (root / "images").mkdir(parents=True)
    (root / "mask").mkdir()
    records = []
    for i in range(3):
        h, w = 30, 40
        ih, iw = (45, 50) if resize else (h, w)
        image = rng.randint(0, 256, (ih, iw, 3)).astype(np.uint8) if i != 1 else \
            rng.randint(0, 65536, (ih, iw)).astype(np.uint16)  # a 16-bit gray image
        cv2.imwrite(str(root / "images" / f"{i}.png"), image)
        mask = np.zeros((h, w, 3), np.uint16)
        mask[..., 1] = rng.randint(0, 5, (h, w)) * (300 if i == 2 else 1)
        mask[..., 2] = rng.randint(0, 3, (h, w))
        cv2.imwrite(str(root / "mask" / f"{i}.png"), mask)
        records.append({"image": [f"images/{i}.png", "depth/x.png"] if i == 0 else f"images/{i}.png",
                        "annotation": f"mask/{i}.png"})
    (root / "meta.json").write_text(json.dumps(records))


@pytest.mark.parametrize("resize", [False, True])
def test_mask_check_equals_jax(tmp_path, resize):
    _mask_set(tmp_path / "set", resize)
    root = str(tmp_path / "set")
    assert TM.label_check(f"{root}/meta.json", root, str(tmp_path / "t"), device="cpu") == \
        JM.label_check(f"{root}/meta.json", root, str(tmp_path / "j")) == 3
    _same_files(tmp_path / "t", tmp_path / "j")
    got = TM.visualize_masks(f"{root}/images/2.png", f"{root}/mask/2.png", alpha=0.3, device="cpu")
    np.testing.assert_array_equal(got, JM.visualize_masks(f"{root}/images/2.png", f"{root}/mask/2.png", alpha=0.3))
    ids = np.random.RandomState(3).randint(0, 700, (20, 30))
    np.testing.assert_array_equal(_u8(TM.colorize_ids(torch.from_numpy(ids))), JM.colorize_ids(ids))


def _history(seed: int, categories=("cup", "box")) -> list[dict]:
    rng = np.random.RandomState(seed)
    out = []
    for e in range(1, 6):
        out.append({"epoch": float(e), "step": 4 * e, "loss": float(rng.rand()), "learning_rate": 1e-4 / e,
                    "grad_norm": float(rng.rand() * 3)})
        ev = {"epoch": float(e), "step": 4 * e, "eval_loss": float(rng.rand()), "eval_map": float(rng.rand()),
              "eval_map_50": float(rng.rand()), "eval_map_75": None, "eval_mar_100": float(rng.rand()),
              "eval_map_small": -1.0}
        ev.update({f"eval_{m}_{c}": float(rng.rand()) for c in categories for m in ("map", "mar_100")})
        out.append(ev)
    return out


def test_plot_logs_series_and_files_equal_jax(tmp_path):
    runs = {}
    for i, cats in enumerate((("cup", "box"), tuple(f"c{k}" for k in range(13)))):
        d = tmp_path / f"run{i}"
        d.mkdir()
        (d / "trainer_state.json").write_text(json.dumps({"log_history": _history(i, cats)}))
        runs[f"run{i}"] = str(d / "trainer_state.json")
    for path in runs.values():
        h = JPL.load_log_history(path)
        assert TPL.load_log_history(path) == h
        assert TPL.per_category_map_keys(h) == JPL.per_category_map_keys(h)
        for key in ("loss", "eval_map", "eval_map_75", "grad_norm", "eval_map_cup"):
            for x_key in ("epoch", "step"):
                assert TPL.extract_series(h, key, x_key) == JPL.extract_series(h, key, x_key)
    want = JPL.plot_multiple_training_metrics(runs, str(tmp_path / "jax"), categories_per_page=12)
    got = TPL.main([*runs.values(), "--names", *runs, "--output_dir", str(tmp_path / "torch")])
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 4  # the fixed panels and 3 pages of 30 category keys
    sizes = [read_png(p).shape for p in got]
    assert sizes[0] == (2 * TPL.PANEL_H, 3 * TPL.PANEL_W, 3)
    assert sizes[1] == (3 * TPL.CATEGORY_H, 4 * TPL.CATEGORY_W, 3)
    assert all(read_png(p).dtype == np.uint8 and (read_png(p) != 255).any() for p in got)


def test_predict_compare_writes_grids(tmp_path):
    rng = np.random.RandomState(4)
    gt, pred = [], []
    for img_id in (3, 8):
        for k in range(3):
            m = np.zeros((30, 40), np.uint8)
            y, x = rng.randint(0, 20), rng.randint(0, 30)
            m[y:y + 10, x:x + 10] = 1
            gt.append({"image_id": img_id, "category_id": 1, "segmentation": rle.encode(m), "score": 1.0})
            pred.append({"image_id": img_id, "category_id": 1, "segmentation": rle.encode(np.roll(m, k, 0)),
                         "score": 0.9})
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "pred.json").write_text(json.dumps(pred))
    out = tmp_path / "viz"
    predict_torch.main(["--compare", "--gt_json", str(tmp_path / "gt.json"), "--model_json",
                        f"ours={tmp_path / 'pred.json'}", "--model_json", f"again={tmp_path / 'pred.json'}",
                        "--output_dir", str(out)], device="cpu")
    assert sorted(os.listdir(out)) == ["compare_3.png", "compare_8.png"]
    grid = read_png(str(out / "compare_3.png"))
    assert grid.shape == (TITLE_H + 30, 3 * 40 + 2 * PANEL_GAP, 3)
    np.testing.assert_array_equal(grid[TITLE_H:, 40 + PANEL_GAP:80 + PANEL_GAP], grid[TITLE_H:, 80 + 2 * PANEL_GAP:])
