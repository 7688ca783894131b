"""Edge grids of the LAB round trip (csrc/lab.cu), shared by its host
emulation test and its card test: every branch threshold of the chain with
its neighbouring float32 values, 0, -0, 1 and NaN, beside a seeded grid."""

import numpy as np

DELTA = 6.0 / 29.0
SPECIAL = np.array([0.0, -0.0, 1.0, np.nan], np.float32)


def neighbours(v, k):
    """The float32 values from k below float32(v) to k above it."""
    out = [np.float32(v)]
    for _ in range(k):
        out.insert(0, np.nextafter(out[0], np.float32(-np.inf)))
        out.append(np.nextafter(out[-1], np.float32(np.inf)))
    return np.array(out, np.float32)


def edge_rgb(rng):
    """(N, 3) sRGB: a seeded grid in [-0.1, 1.2]; each channel at the sRGB
    knee and at 0.0031308 and their neighbours; grays whose linear value
    crosses (6/29)^3, where lab_f turns; 0, -0, 1 and NaN in every channel
    and beside ordinary values."""
    grid = rng.uniform(-0.1, 1.2, (1500, 3)).astype(np.float32)
    knee = np.concatenate([neighbours(0.04045, 24), neighbours(0.0031308, 24)])
    d3 = DELTA ** 3   # the sRGB value whose decode is (6/29)^3
    gray = neighbours(1.055 * d3 ** (1 / 2.4) - 0.055, 64)
    special = np.array(np.meshgrid(SPECIAL, SPECIAL, [0.5, 0.0, np.nan])).reshape(3, -1).T
    return np.concatenate([grid, np.stack([knee, np.roll(knee, 5), knee[::-1]], -1),
                           np.repeat(gray[:, None], 3, 1), special]).astype(np.float32)


def edge_merge(rng, lab):
    """(lab (N, 3), lum (N,)) from the LAB of `edge_rgb` (numpy (n, 3)): a
    seeded new plane in [-0.1, 1.2]; grays (a = b = 0) whose L crosses 6/29
    in f (L = 0.08) and whose linear value crosses 0.0031308, where the
    encode turns; L at 0.08 with a and b crossing 6/29 in fx and fz; 0, -0,
    1 and NaN."""
    lum = rng.uniform(-0.1, 1.2, len(lab)).astype(np.float32)
    f_knee = 0.0031308 / (3 * DELTA ** 2) + 4 / 29   # f of Y = 0.0031308 (linear branch)
    gray_l = np.concatenate([neighbours(0.08, 64), neighbours((116 * f_knee - 16) / 100, 64),
                             SPECIAL])
    ab = np.concatenate([neighbours(0.0, 16), -neighbours(0.0, 16), SPECIAL])
    edge = np.array(np.meshgrid(neighbours(0.08, 3), ab, ab)).reshape(3, -1).T
    lab = np.concatenate([lab, np.stack([gray_l, 0 * gray_l, 0 * gray_l], -1), edge])
    lum = np.concatenate([lum, gray_l, edge[:, 0]])
    return lab.astype(np.float32), lum.astype(np.float32)
