"""The feature bars of the port's tests: atol 2e-3 / rtol 1e-4
(tests/test_ref_feat_golden.py's), PLP atol 5e-3 / rtol 1e-3
(tests/test_plp_resample.py:82).  The spectrogram's log power of a bin
carries the float32 FFT's rounding, which is absolute (about eps times
the frame's spectral norm): at a deep spectral null the log turns it
into a large difference between any two implementations, so each of its
elements also gets 4 eps sqrt(S / P), S the frame's power summed over
the bins after the first and P the bin's (first-order: d log P =
2 d|X| / |X|, |dX| <= 2 eps ||X||)."""

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)


def feature_tolerance(kind: str, ref: np.ndarray) -> np.ndarray:
    """The elementwise bar of a feature type against the reference
    array `ref` (..., dim)."""
    if kind == "plp":
        return 5e-3 + 1e-3 * np.abs(ref)
    tol = 2e-3 + 1e-4 * np.abs(ref)
    if kind == "spectrogram":
        power = np.exp(ref[..., 1:].astype(np.float64))
        total = power.sum(axis=-1, keepdims=True)
        tol = tol.astype(np.float64)
        tol[..., 1:] += 4 * EPS32 * np.sqrt(total / power)
    return tol


def assert_features_close(kind: str, got, ref, msg: str = "") -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape, msg)
    excess = np.abs(got.astype(np.float64) - ref) - \
        feature_tolerance(kind, ref)
    bad = np.argwhere(excess > 0)
    assert not len(bad), (f"{msg}: {len(bad)} elements past the bar, the "
                          f"worst by {excess.max():.3g} at "
                          f"{tuple(bad[np.argmax(excess[excess > 0])])}")
