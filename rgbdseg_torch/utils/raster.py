"""Drawing on uint8 RGB canvases: the port's stand-in for matplotlib, as
`data/image_io` is for PIL (the card's machine has neither).

- `canvas`, `fill_rect`, `rect`: blank images and filled or outlined boxes;
- `line` / `polyline`: 1-pixel lines, solid ("-"), dashed ("--") or dotted
  (":"), the dash pattern running on along a polyline;
- `text`: a fixed 5x7 ASCII bitmap font (`FONT`, one column byte per glyph
  column, bit 0 the top row), scaled by whole pixels;
- `Axes`: a plot panel with a frame, ticks at 1-2-5 steps with their labels,
  a title, an x label, an optional right-hand axis for a second series
  scale, and a legend of line samples;
- `COLORS`: matplotlib's default colour cycle (tab10), so curves keep the
  colours the JAX tool's figures give them.

Coordinates are (x, y) pixels with y down; everything is clipped to the
canvas.
"""

from __future__ import annotations

import math

import numpy as np

WHITE, BLACK, GRAY = (255, 255, 255), (0, 0, 0), (128, 128, 128)
COLORS = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75),
          (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207)]
_PATTERNS = {"-": (1,), "--": (6, 4), ":": (1, 2)}  # on, off, on, ... pixels

# ASCII 32..126, five column bytes each (bit 0 = top row of seven).
FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649552250" "0005030000"
    "001c224100" "0041221c00" "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000" "2010080402"
    "3e5149453e" "00427f4000" "4261514946" "2141454b31" "1814127f10" "2745454539" "3c4a494930" "0171090503"
    "3649494936" "064949291e" "0036360000" "0056360000" "0814224100" "1414141414" "0041221408" "0201510906"
    "324979413e" "7e1111117e" "7f49494936" "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040" "7f0204027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f" "7f2018207f"
    "6314081463" "0304780403" "6151494543" "007f414100" "0204081020" "0041417f00" "0402010204" "4040404040"
    "0001020400" "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418" "087e090102" "081454543c"
    "7f08040478" "00447d4000" "2040443d00" "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020" "3c4040207c" "1c2040201c" "3c4030403c"
    "4428102844" "0c5050503c" "4464544c44" "0008364100" "00007f0000" "0041360800" "1008081008"
)
GLYPH_W, GLYPH_H = 5, 7


def canvas(h: int, w: int, color=WHITE) -> np.ndarray:
    return np.full((h, w, 3), color, np.uint8)


def fill_rect(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Fill the pixels x0 <= x < x1, y0 <= y < y1."""
    h, w = img.shape[:2]
    img[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = color


def rect(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Outline the box with corners (x0, y0) and (x1, y1), both inclusive."""
    polyline(img, [x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], color)


def _segment(x0, y0, x1, y1) -> tuple[np.ndarray, np.ndarray]:
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    t = np.linspace(0.0, 1.0, n)
    return np.rint(x0 + (x1 - x0) * t).astype(np.int64), np.rint(y0 + (y1 - y0) * t).astype(np.int64)


def polyline(img: np.ndarray, xs, ys, color, style: str = "-") -> None:
    """Join the points (xs[i], ys[i]) by 1-pixel lines."""
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    if len(xs) == 1:
        xs, ys = np.repeat(xs, 2), np.repeat(ys, 2)
    parts = [_segment(xs[i], ys[i], xs[i + 1], ys[i + 1]) for i in range(len(xs) - 1)]
    if not parts:
        return
    px = np.concatenate([p[0] for p in parts])
    py = np.concatenate([p[1] for p in parts])
    pattern = np.asarray(_PATTERNS[style])
    period = np.repeat(np.arange(len(pattern)) % 2 == 0, pattern)  # True where the pen is down
    keep = period[np.arange(len(px)) % len(period)]
    h, w = img.shape[:2]
    keep &= (px >= 0) & (px < w) & (py >= 0) & (py < h)
    img[py[keep], px[keep]] = color


def line(img: np.ndarray, x0, y0, x1, y1, color, style: str = "-") -> None:
    polyline(img, [x0, x1], [y0, y1], color, style)


def text_size(s: str, scale: int = 1) -> tuple[int, int]:
    """(width, height) in pixels of `s` drawn by `text`."""
    return max(len(s) * (GLYPH_W + 1) - 1, 0) * scale, GLYPH_H * scale


def text(img: np.ndarray, x: int, y: int, s: str, color=BLACK, scale: int = 1) -> None:
    """Draw `s` with its top-left corner at (x, y); characters outside
    ASCII 32..126 are drawn as '?'."""
    h, w = img.shape[:2]
    for i, ch in enumerate(s):
        code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
        cols = np.frombuffer(FONT, np.uint8)[(code - 32) * GLYPH_W:(code - 31) * GLYPH_W]
        bits = (cols[None, :] >> np.arange(GLYPH_H)[:, None]) & 1  # (7, 5)
        bits = np.kron(bits, np.ones((scale, scale), np.uint8)).astype(bool)
        gy, gx = np.nonzero(bits)
        gx = gx + x + i * (GLYPH_W + 1) * scale
        gy = gy + y
        keep = (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)
        img[gy[keep], gx[keep]] = color


def nice_ticks(lo: float, hi: float, target: int = 5) -> list[float]:
    """Tick values at a 1-2-5 step inside [lo, hi]."""
    if not (math.isfinite(lo) and math.isfinite(hi)) or hi <= lo:
        return [lo] if math.isfinite(lo) else []
    raw = (hi - lo) / target
    mag = 10 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9)
    return [k * step for k in range(first, int(math.floor(hi / step + 1e-9)) + 1)]


def tick_label(v: float) -> str:
    return f"{v:.4g}" if v else "0"


def _limits(values: list[float]) -> tuple[float, float]:
    vals = [v for v in values if v is not None and math.isfinite(v)]
    if not vals:
        return 0.0, 1.0
    lo, hi = min(vals), max(vals)
    if hi == lo:
        pad = abs(lo) * 0.05 or 0.5
        return lo - pad, hi + pad
    pad = (hi - lo) * 0.05
    return lo - pad, hi + pad


class Axes:
    """One plot panel in the box (x0, y0) .. (x0 + w, y0 + h) of `img`."""

    LEFT, RIGHT, TOP, BOTTOM = 56, 16, 22, 34

    def __init__(self, img: np.ndarray, x0: int, y0: int, w: int, h: int, twin: bool = False):
        self.img = img
        self.right = self.RIGHT + (48 if twin else 0)
        self.px0, self.py0 = x0 + self.LEFT, y0 + self.TOP
        self.px1, self.py1 = x0 + w - self.right, y0 + h - self.BOTTOM
        self.box = (x0, y0, w, h)
        self.series: list[tuple] = []  # (xs, ys, color, style, label, right axis)

    def plot(self, xs, ys, color, style: str = "-", label: str = "", right: bool = False) -> None:
        self.series.append((list(xs), list(ys), color, style, label, right))

    def draw(self, title: str = "", xlabel: str = "", right_label: str = "") -> None:
        img = self.img
        xs = [x for s in self.series for x in s[0]]
        xlo, xhi = _limits(xs)
        limits = {side: _limits([y for s in self.series if s[5] == side for y in s[1]]) for side in (False, True)}
        rect(img, self.px0, self.py0, self.px1, self.py1, BLACK)

        def to_px(v, lo, hi, a, b):
            return a + (v - lo) / (hi - lo) * (b - a)

        for t in nice_ticks(xlo, xhi):
            x = int(round(to_px(t, xlo, xhi, self.px0, self.px1)))
            line(img, x, self.py1, x, self.py1 + 3, BLACK)
            label = tick_label(t)
            tw, _ = text_size(label)
            text(img, x - tw // 2, self.py1 + 6, label)
        for side in (False, True):
            if side and not any(s[5] for s in self.series):
                continue
            lo, hi = limits[side]
            for t in nice_ticks(lo, hi):
                y = int(round(to_px(t, lo, hi, self.py1, self.py0)))
                label = tick_label(t)
                tw, th = text_size(label)
                if side:
                    line(img, self.px1, y, self.px1 + 3, y, BLACK)
                    text(img, self.px1 + 6, y - th // 2, label)
                else:
                    line(img, self.px0 - 3, y, self.px0, y, BLACK)
                    text(img, self.px0 - 6 - tw, y - th // 2, label)
        for sx, sy, color, style, _, side in self.series:
            lo, hi = limits[side]
            pts = [(to_px(x, xlo, xhi, self.px0, self.px1), to_px(y, lo, hi, self.py1, self.py0))
                   for x, y in zip(sx, sy) if y is not None and math.isfinite(y)]
            if pts:
                polyline(img, [p[0] for p in pts], [p[1] for p in pts], color, style)
        x0, y0, w, h = self.box
        if title:
            tw, _ = text_size(title, 2)
            text(img, x0 + (w - tw) // 2, y0 + 4, title, scale=2)
        if xlabel:
            tw, th = text_size(xlabel)
            text(img, (self.px0 + self.px1 - tw) // 2, y0 + h - th - 4, xlabel)
        if right_label:
            tw, _ = text_size(right_label)
            text(img, x0 + w - tw - 2, y0 + 4, right_label, GRAY)
        self._legend()

    def _legend(self) -> None:
        entries = [(s[4], s[2], s[3]) for s in self.series if s[4]]
        if not entries:
            return
        width = max(text_size(label)[0] for label, _, _ in entries) + 34
        height = 12 * len(entries) + 6
        x0, y0 = self.px1 - width - 4, self.py0 + 4
        fill_rect(self.img, x0, y0, x0 + width, y0 + height, WHITE)
        rect(self.img, x0, y0, x0 + width, y0 + height, GRAY)
        for i, (label, color, style) in enumerate(entries):
            y = y0 + 6 + 12 * i
            line(self.img, x0 + 4, y + 3, x0 + 24, y + 3, color, style)
            text(self.img, x0 + 30, y, label)
