"""Small pieces the harness shares: percentiles, the card's line, the
watermark font. ``percentile``, ``card_line`` and
``ensure_font`` are frozen copies of the program's bench helpers, so that
a change to the program cannot move the yardstick."""

from __future__ import annotations

import glob
import os
import subprocess

from perfbench import spec


def percentile(sorted_vals, p: float) -> float:
    """The reference bench's percentile rule (bench.py:633)."""
    return sorted_vals[min(int(len(sorted_vals) * p), len(sorted_vals) - 1)]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ensure_font() -> str:
    """The watermark font both the program and the reference use: a
    TrueType font on the host (DejaVu Sans first), else Pillow's bundled
    default written under the checkout's build/fonts/."""
    import site

    roots = ["/usr/share/fonts", "/usr/local/share/fonts", *site.getsitepackages()]
    found = sorted({f for r in roots
                    for f in glob.glob(os.path.join(r, "**", "*.ttf"), recursive=True)},
                   key=lambda f: (os.path.basename(f) != "DejaVuSans.ttf", f))
    if found:
        return found[0]
    from PIL import ImageFont

    path = str(spec.repo_root() / "build" / "fonts" / "pillow-default.ttf")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            f.write(ImageFont.load_default(36).font_bytes)
        os.replace(path + ".tmp", path)
    return path
