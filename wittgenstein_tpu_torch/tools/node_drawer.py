"""Node maps — the port of `wittgenstein_tpu/tools/node_drawer.py`
(tools/NodeDrawer.java, with PIL).

Draws every node at its map position, colored red -> green by a value
in [vmin, vmax]; frames accumulate into an animated GIF.  The background
is the world map `data/world-map-2000px.png` (a byte copy of the JAX
package's, the reference's bundled image), with a synthesized graticule
where the file is absent.  PIL is imported inside the functions that
draw, so this module imports without it.  Node positions and values may
be tensors on any device or numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.state import MAX_X, MAX_Y

_MAP_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "data", "world-map-2000px.png")
_MAP_CACHE = None


def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _background():
    """A copy of the frame background
    (wittgenstein_tpu/tools/node_drawer.py:24-41)."""
    from PIL import Image, ImageDraw
    global _MAP_CACHE
    if _MAP_CACHE is not None:
        return _MAP_CACHE.copy()    # ImageDraw mutates the frame
    if os.path.exists(_MAP_PATH):
        img = Image.open(_MAP_PATH).convert("RGB")
        if img.size != (MAX_X, MAX_Y):
            img = img.resize((MAX_X, MAX_Y))
        _MAP_CACHE = img
        return img.copy()
    img = Image.new("RGB", (MAX_X, MAX_Y), (12, 18, 32))
    d = ImageDraw.Draw(img)
    for x in range(0, MAX_X, 125):
        d.line([(x, 0), (x, MAX_Y)], fill=(28, 38, 58))
    for y in range(0, MAX_Y, 125):
        d.line([(0, y), (MAX_X, y)], fill=(28, 38, 58))
    return img


class NodeDrawer:
    """status(nodes) -> per-node value; red (vmin) -> green (vmax)
    (wittgenstein_tpu/tools/node_drawer.py:44-84)."""

    def __init__(self, vmin: float, vmax: float, dot: int = 4):
        self.vmin, self.vmax = float(vmin), float(vmax)
        self.dot = dot
        self.frames: list = []

    def draw(self, nodes, values, special=None):
        from PIL import ImageDraw
        img = _background()
        d = ImageDraw.Draw(img)
        xs = _np(nodes.x)
        ys = _np(nodes.y)
        down = _np(nodes.down)
        vals = _np(values).astype(np.float64)
        special = None if special is None else _np(special)
        span = max(self.vmax - self.vmin, 1e-9)
        r = self.dot
        for i in range(len(xs)):
            if down[i]:
                color = (90, 90, 90)
            else:
                f = min(max((vals[i] - self.vmin) / span, 0.0), 1.0)
                color = (int(255 * (1 - f)), int(255 * f), 40)
            box = (xs[i] - r, ys[i] - r, xs[i] + r, ys[i] + r)
            if special is not None and special[i]:
                d.ellipse((box[0] - 2, box[1] - 2, box[2] + 2, box[3] + 2),
                          outline=(255, 255, 0))
            d.ellipse(box, fill=color)
        self.frames.append(img)
        return img

    def save_png(self, path: str):
        self.frames[-1].save(path)

    def save_gif(self, path: str, ms_per_frame: int = 150):
        if not self.frames:
            raise ValueError("no frames drawn")
        self.frames[0].save(path, save_all=True,
                            append_images=self.frames[1:],
                            duration=ms_per_frame, loop=0)
