"""Device selection and float32 precision control for the port."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means CUDA.  CUDA asked for on a machine without it raises;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_f32_lock = threading.Lock()
_f32_depth = 0
_f32_saved = False


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run float32 matmuls in full float32 (TF32 off) inside the block,
    restoring the caller's setting after.  The reference pins these
    products to `Precision.HIGHEST` for the same reason: MFCC and
    i-vector statistics need the whole f32 mantissa.  The switch is
    process-wide, so blocks open in several threads at once (the TCP
    server's connections) share one: the first to enter saves the
    setting and the last to leave restores it."""
    global _f32_depth, _f32_saved
    with _f32_lock:
        if _f32_depth == 0:
            _f32_saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_depth -= 1
            if _f32_depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = _f32_saved


def same_device(a: torch.device, b: torch.device) -> bool:
    """True when two devices name the same card (cuda == cuda:0)."""
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib


# frames a device pass scores at once (the (T, D*D) outer products of a
# 40-dim chunk take 210 MB in float64)
CHUNK_FRAMES = 16384


def frame_chunks(feats_list, device, chunk: int = CHUNK_FRAMES):
    """Concatenated float64 frames of the host (T, D) arrays of
    `feats_list` on `device`, in chunks of at most `chunk` rows (an
    array longer than that is its own chunk)."""
    buf, n = [], 0
    for f in feats_list:
        f = np.asarray(f, np.float64)
        if n and n + f.shape[0] > chunk:
            yield torch.from_numpy(np.concatenate(buf)).to(device)
            buf, n = [], 0
        buf.append(f)
        n += f.shape[0]
    if buf:
        yield torch.from_numpy(np.concatenate(buf)).to(device)
