"""Camera distortion models on the host, in float64 numpy, as OpenCV computes
them (the offline tools' undistortion; no OpenCV).

  optimal_new_camera_matrix        cv2.getOptimalNewCameraMatrix with
                                   centerPrincipalPoint=True
  init_undistort_rectify_map       cv2.initUndistortRectifyMap, CV_32FC1
                                   maps, for OpenCV's radial-tangential model
                                   of 0, 4, 5 or 8 coefficients (k1 k2 p1 p2
                                   [k3 [k4 k5 k6]])
  fisheye_estimate_new_camera_matrix
                                   cv2.fisheye.estimateNewCameraMatrixFor-
                                   UndistortRectify
  fisheye_init_undistort_rectify_map
                                   cv2.fisheye.initUndistortRectifyMap,
                                   CV_32FC1 maps (k1..k4 on the angle)

Each follows OpenCV's operation order, so matrices agree to ~1e-15 relative
and maps to float32 rounding; tests/test_torch_codecs.py holds them to
OpenCV. Rotations other than the identity are not used by the port.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _coeffs(dist: Sequence[float]) -> np.ndarray:
    """k1 k2 p1 p2 k3 k4 k5 k6 from 0, 4, 5 or 8 coefficients (the rest
    zero)."""
    d = np.asarray(dist, np.float64).reshape(-1)
    if d.size not in (0, 4, 5, 8):
        raise ValueError(f"the radial-tangential model takes 0, 4, 5 or 8 coefficients, "
                         f"got {d.size}")
    k = np.zeros(8)
    k[:d.size] = d
    return k


def undistort_points(pts: np.ndarray, K: np.ndarray, dist: Sequence[float],
                     P: np.ndarray = None, iterations: int = 5) -> np.ndarray:
    """cv2.undistortPoints(pts, K, dist, P=P) of (N, 2) pixel points: the
    fixed-point iteration x = (x0 - delta(x)) / radial(x), 5 times, as
    OpenCV's default criteria run it; into P's pixels (or normalised
    coordinates when P is None)."""
    k = _coeffs(dist)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    x0 = x = (u - cx) * (1.0 / fx)
    y0 = y = (v - cy) * (1.0 / fy)
    done = np.zeros(len(pts), bool)
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = ((1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2)
                  / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2))
        # a negative radial factor stops the iteration at the distorted point
        stop = ~done & (icdist < 0)
        x = np.where(stop, (u - cx) * (1.0 / fx), x)
        y = np.where(stop, (v - cy) * (1.0 / fy), y)
        done |= stop
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
        x = np.where(done, x, (x0 - dx) * icdist)
        y = np.where(done, y, (y0 - dy) * icdist)
    if P is None:
        return np.stack([x, y], -1)
    P = np.asarray(P, np.float64)
    xx = P[0, 0] * x + P[0, 1] * y + P[0, 2]
    yy = P[1, 0] * x + P[1, 1] * y + P[1, 2]
    ww = 1.0 / (P[2, 0] * x + P[2, 1] * y + P[2, 2])
    return np.stack([xx * ww, yy * ww], -1)


def _undistort_rectangles(K, dist, size_wh) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """OpenCV's getUndistortRectangles into K's own pixels: the inscribed
    and the bounding rectangle (x, y, w, h) of a 9x9 grid of undistorted
    image points."""
    n = 9
    w, h = size_wh
    gy, gx = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64),
                         indexing="ij")
    grid = np.stack([gx * (w - 1) / (n - 1), gy * (h - 1) / (n - 1)], -1).reshape(-1, 2)
    p = undistort_points(grid, K, dist, P=K).reshape(n, n, 2)
    ox0, ox1 = p[..., 0].min(), p[..., 0].max()
    oy0, oy1 = p[..., 1].min(), p[..., 1].max()
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def optimal_new_camera_matrix(K: np.ndarray, dist: Sequence[float], size_wh: Tuple[int, int],
                              alpha: float, new_size_wh: Tuple[int, int] = None,
                              center_principal_point: bool = True) -> np.ndarray:
    """cv2.getOptimalNewCameraMatrix(K, dist, size, alpha, new_size,
    centerPrincipalPoint=True)[0]: the principal point at the new image's
    centre ((size - 1) / 2, OpenCV 5's rule), the focal scaled so that
    alpha 0 keeps only valid pixels and alpha 1 keeps every source pixel."""
    if not center_principal_point:
        raise ValueError("only centerPrincipalPoint=True is implemented")
    new_w, new_h = new_size_wh if new_size_wh and new_size_wh[0] * new_size_wh[1] else size_wh
    M = np.asarray(K, np.float64).copy()
    cx0, cy0 = M[0, 2], M[1, 2]
    cx, cy = (new_w - 1) * 0.5, (new_h - 1) * 0.5
    inner, outer = _undistort_rectangles(M, dist, size_wh)
    s0 = max(max(max(cx / (cx0 - inner[0]), cy / (cy0 - inner[1])),
                 cx / (inner[0] + inner[2] - cx0)), cy / (inner[1] + inner[3] - cy0))
    s1 = min(min(min(cx / (cx0 - outer[0]), cy / (cy0 - outer[1])),
                 cx / (outer[0] + outer[2] - cx0)), cy / (outer[1] + outer[3] - cy0))
    s = s0 * (1 - alpha) + s1 * alpha
    M[0, 0] *= s
    M[1, 1] *= s
    M[0, 2], M[1, 2] = cx, cy
    return M


def init_undistort_rectify_map(K: np.ndarray, dist: Sequence[float], new_K: np.ndarray,
                               size_wh: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.initUndistortRectifyMap(K, dist, I, new_K, size, CV_32FC1):
    (map_x, map_y) float32 (H, W), for each output pixel the distorted
    source position of its ray through new_K."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _coeffs(dist)
    K = np.asarray(K, np.float64)
    ir = np.linalg.inv(np.asarray(new_K, np.float64)).reshape(-1)
    w, h = size_wh
    i = np.arange(h, dtype=np.float64)[:, None]
    j = np.arange(w, dtype=np.float64)[None]
    _x = i * ir[1] + ir[2] + j * ir[0]
    _y = i * ir[4] + ir[5] + j * ir[3]
    _w = i * ir[7] + ir[8] + j * ir[6]
    ww = 1.0 / _w
    x, y = _x * ww, _y * ww
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def _fisheye_undistort_points(pts: np.ndarray, K: np.ndarray, k: np.ndarray,
                              iterations: int = 10, eps: float = 1e-8) -> np.ndarray:
    """cv2.fisheye.undistortPoints(pts, K, k) into normalised coordinates:
    Newton's method on theta_d = theta (1 + k1 theta^2 + ... + k4 theta^8),
    at most 10 steps, stopping below 1e-8 (OpenCV's default criteria)."""
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    out = []
    for p in np.asarray(pts, np.float64):
        pw = (p - c) / f
        theta_d = np.sqrt(pw[0] * pw[0] + pw[1] * pw[1])
        theta_d = min(max(-np.pi / 2.0, theta_d), np.pi / 2.0)
        theta, converged, scale = theta_d, False, 0.0
        if abs(theta_d) > eps:
            for _ in range(iterations):
                t2 = theta * theta
                t4 = t2 * t2
                t6 = t4 * t2
                t8 = t6 * t2
                a, b, cc, d = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
                fix = ((theta * (1 + a + b + cc + d) - theta_d)
                       / (1 + 3 * a + 5 * b + 7 * cc + 9 * d))
                theta = theta - fix
                if abs(fix) < eps:
                    converged = True
                    break
            scale = np.tan(theta) / theta_d
        else:
            converged = True
        flipped = (theta_d < 0 < theta) or (theta < 0 < theta_d)
        if not converged or flipped:
            out.append((-1000000.0, -1000000.0))
        else:
            out.append(tuple(pw * scale))
    return np.asarray(out)


def fisheye_estimate_new_camera_matrix(K: np.ndarray, dist: Sequence[float],
                                       size_wh: Tuple[int, int], balance: float = 0.0,
                                       fov_scale: float = 1.0) -> np.ndarray:
    """cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, dist, size,
    I, balance=balance): a focal between the one that keeps the undistorted
    edge midpoints inside (balance 1) and the one that fills the image with
    them (balance 0), the principal point at their centre."""
    K = np.asarray(K, np.float64)
    k = np.asarray(dist, np.float64).reshape(-1)
    if k.size != 4:
        raise ValueError(f"the fisheye model takes 4 coefficients, got {k.size}")
    w, h = size_wh
    balance = min(max(balance, 0.0), 1.0)
    pts = np.array([[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]], np.float64)
    p = _fisheye_undistort_points(pts, K, k)
    cn = (p[0] + p[1] + p[2] + p[3]) * (1.0 / 4)
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    p[:, 1] *= aspect
    minx, maxx, miny, maxy = p[:, 0].min(), p[:, 0].max(), p[:, 1].min(), p[:, 1].max()
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    fmin = min(f1, min(f2, min(f3, f4)))
    fmax = max(f1, max(f2, max(f3, f4)))
    f = balance * fmin + (1.0 - balance) * fmax
    f *= 1.0 / fov_scale if fov_scale > 0 else 1.0
    new_c = -cn * f + np.array([w, h * aspect]) * 0.5
    return np.array([[f, 0.0, new_c[0]], [0.0, f / aspect, new_c[1] / aspect],
                     [0.0, 0.0, 1.0]])


def fisheye_init_undistort_rectify_map(K: np.ndarray, dist: Sequence[float], new_K: np.ndarray,
                                       size_wh: Tuple[int, int]
                                       ) -> Tuple[np.ndarray, np.ndarray]:
    """cv2.fisheye.initUndistortRectifyMap(K, dist, I, new_K, size,
    CV_32FC1): each output ray's angle theta from the axis distorted to
    theta (1 + k1 theta^2 + k2 theta^4 + k3 theta^6 + k4 theta^8) through K."""
    K = np.asarray(K, np.float64)
    k = np.asarray(dist, np.float64).reshape(-1)
    iR = np.linalg.inv(np.asarray(new_K, np.float64))
    w, h = size_wh
    i = np.arange(h, dtype=np.float64)

    def walk(r):        # a row's start, then one step per column, summed in order
        steps = np.empty((h, w))
        steps[:, 0] = i * iR[r, 1] + iR[r, 2]
        steps[:, 1:] = iR[r, 0]
        return np.cumsum(steps, axis=1)

    _x, _y, _w = walk(0), walk(1), walk(2)
    with np.errstate(divide="ignore", invalid="ignore"):
        x, y = _x / _w, _y / _w
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t4 * t4
        theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8)
        scale = np.where(r == 0, 1.0, theta_d / r)
        u = K[0, 0] * x * scale + K[0, 2]
        v = K[1, 1] * y * scale + K[1, 2]
    behind = _w <= 0
    u = np.where(behind, np.where(_x > 0, -np.inf, np.inf), u)
    v = np.where(behind, np.where(_y > 0, -np.inf, np.inf), v)
    return u.astype(np.float32), v.astype(np.float32)
