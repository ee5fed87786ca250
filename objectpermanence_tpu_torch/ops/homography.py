"""Image plane -> CATER ground plane -> 6 x 6 grid class, the port's copy of
the parts of `objectpermanence_tpu/ops/homography.py` that
`cater_inference` needs (numpy, no OpenCV).

The homography maps image points in [-1, 1] coordinates back to the object
plane z = `PLANE_Z` of the fixed CATER render camera; `get_class_prediction`
and `grid_classes_for_centers` bin the mapped point into the 36 grid
classes. The camera-motion helpers (`camera_center`, `camera_matrix_at`,
`project_3d_point`'s `cam`) are not ported yet (ROADMAP.md, Next slices,
item 8).
"""

import math

import numpy as np

# the fixed CATER render camera
CATER_CAM = np.array([
    (1.4503, 1.6376, 0.0000, -0.0251),
    (-1.0346, 0.9163, 2.5685, 0.0095),
    (-0.6606, 0.5850, -0.4748, 10.5666),
    (-0.6592, 0.5839, -0.4738, 10.7452),
])

# height of the CATER object plane
PLANE_Z = 0.3421497941017151


def project_3d_point(pts: np.ndarray) -> np.ndarray:
    """(N, 3) world points -> (N, 2) image coordinates in [-1, 1] through the
    CATER camera, the Y axis negated so that low Y is at the top."""
    pts = np.asarray(pts, dtype=np.float64)
    homo = np.hstack([pts, np.ones((pts.shape[0], 1))])
    p = (CATER_CAM @ homo.T).T
    out = np.empty((pts.shape[0], 2))
    out[:, 0] = p[:, 0] / p[:, -1]
    out[:, 1] = -p[:, 1] / p[:, -1]
    return out


def fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT fit of the 3 x 3 homography H with dst ~ H @ src (homogeneous),
    as `cv2.findHomography` in the exact 4-point case."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    a = []
    for (x, y), (u, v) in zip(src, dst):
        a.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        a.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, vt = np.linalg.svd(np.asarray(a))
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


def _ground_plane_homography() -> np.ndarray:
    """Image plane -> ground plane (z = PLANE_Z), fit from 4 points."""
    points_3d = np.array([
        [-3.0, -3.0, PLANE_Z],
        [0.0, 3.0, PLANE_Z],
        [-3.0, 0.0, PLANE_Z],
        [0.0, 0.0, PLANE_Z],
    ])
    return fit_homography(project_3d_point(points_3d), points_3d[:, :2])


H_IMAGE_TO_PLANE = _ground_plane_homography()


def perspective_transform(points: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Apply the homography `h` to (N, 2) points (`cv2.perspectiveTransform`)."""
    points = np.asarray(points, dtype=np.float64)
    homo = np.hstack([points, np.ones((points.shape[0], 1))])
    mapped = (h @ homo.T).T
    return mapped[:, :2] / mapped[:, 2:3]


def get_class_prediction(cx: float, cy: float, nrows: int = 3, ncols: int = 3) -> int:
    """An image point in [-1, 1] coordinates -> its grid class; with
    nrows = ncols = 3 the grid has 6 x 6 = 36 classes."""
    pt = perspective_transform(np.array([[cx, cy]]), H_IMAGE_TO_PLANE)[0]
    x = min(max(-3.0, pt[0]), 3.0 - 1e-5) * ncols / 3.0
    y = min(max(-3.0, pt[1]), 3.0 - 1e-5) * nrows / 3.0
    cls_id = (int(math.floor(y)) + nrows) * (2 * ncols) + int(math.floor(x)) + ncols
    assert 0 <= cls_id < 4 * nrows * ncols, f"cls_id: {cls_id} x: {x} y: {y}"
    return cls_id


def grid_classes_for_centers(centers_px: np.ndarray, frame_w: int = 320,
                             frame_h: int = 240) -> np.ndarray:
    """(N, 2) pixel centres -> their 36-way grid classes, vectorized."""
    centers_px = np.asarray(centers_px, dtype=np.float64)
    norm = np.stack([centers_px[:, 0] * 2.0 / frame_w - 1.0,
                     centers_px[:, 1] * 2.0 / frame_h - 1.0], axis=-1)
    pts = perspective_transform(norm, H_IMAGE_TO_PLANE)
    x = np.clip(pts[:, 0], -3.0, 3.0 - 1e-5)
    y = np.clip(pts[:, 1], -3.0, 3.0 - 1e-5)
    return (np.floor(y).astype(np.int64) + 3) * 6 + np.floor(x).astype(np.int64) + 3
