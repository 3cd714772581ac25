"""Point-cloud rendering, headless (a copy of rap_tpu/utils/render.py; the
port imports nothing of rap_tpu).

The 64-colour part palette (golden-angle hues), probability and PCA
colourings, and three renderers of (N, 3) points to an (H, W, 3) uint8
image: the matplotlib 3D scatter (``render_point_cloud``), the numpy
z-buffer raster (``render_point_cloud_raster``: orthographic, occlusion by
nearest depth) and the shaded renderer (``render_point_cloud_shaded``:
k-NN normals, two lights, ambient occlusion and a ground shadow), with the
dispatcher ``visualize_point_clouds`` and PNG / GIF writers (PIL). Host
numpy; matplotlib, PIL and scipy are imported where they are used.
"""

from __future__ import annotations

import colorsys
import io
from pathlib import Path

import numpy as np

_N_PART_COLORS = 64


def part_colormap(n: int = _N_PART_COLORS) -> np.ndarray:
    """(n, 3) float RGB palette with evenly spaced hues (golden-angle order)."""
    cols = []
    for i in range(n):
        h = (i * 0.61803398875) % 1.0
        s = 0.65 + 0.25 * ((i // 7) % 2)
        v = 0.95 - 0.25 * ((i // 3) % 2)
        cols.append(colorsys.hsv_to_rgb(h, min(s, 1.0), v))
    return np.asarray(cols, np.float32)


def part_ids_to_colors(part_ids: np.ndarray) -> np.ndarray:
    cmap = part_colormap()
    return cmap[np.asarray(part_ids) % len(cmap)]


def prob_to_colors(prob: np.ndarray, cmap_name: str = "viridis") -> np.ndarray:
    import matplotlib.cm as cm

    return np.asarray(cm.get_cmap(cmap_name)(np.clip(prob, 0, 1)))[..., :3]


def pca_colors(features: np.ndarray, basis: np.ndarray | None = None):
    """Project features to RGB via 3-component PCA.

    Returns (colors (N,3) in [0,1], basis) — pass the basis back in to keep
    coloring consistent across batches (ref visualizer.py:191-301 freezes the
    PCA basis from the first batch).
    """
    f = np.asarray(features, np.float64)
    f = f - f.mean(0, keepdims=True)
    if basis is None:
        _, _, vt = np.linalg.svd(f, full_matrices=False)
        basis = vt[:3]
    proj = f @ basis.T
    lo, hi = np.percentile(proj, 2, axis=0), np.percentile(proj, 98, axis=0)
    colors = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return colors.astype(np.float32), basis


def render_point_cloud(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    image_size: int = 512,
    point_size: float = 2.0,
    elev: float = 25.0,
    azim: float = 45.0,
    title: str | None = None,
) -> np.ndarray:
    """Render (N,3) points to an (H,W,3) uint8 image (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(image_size / 100, image_size / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    pts = np.asarray(points)
    ax.scatter(
        pts[:, 0], pts[:, 1], pts[:, 2], c=colors, s=point_size, linewidths=0
    )
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    if title:
        ax.set_title(title, fontsize=8)
    # equal aspect
    if len(pts):
        c = pts.mean(0)
        r = max(float(np.abs(pts - c).max()), 1e-6)
        ax.set_xlim(c[0] - r, c[0] + r)
        ax.set_ylim(c[1] - r, c[1] + r)
        ax.set_zlim(c[2] - r, c[2] + r)
    fig.tight_layout(pad=0)
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    buf.seek(0)
    from PIL import Image

    img = np.asarray(Image.open(buf).convert("RGB"))
    return img


def save_image(path, image: np.ndarray) -> None:
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(image).save(path)


def read_image(path) -> np.ndarray:
    """An image file as (H, W, 3) uint8 (the inverse of ``save_image``)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def save_gif(path, frames: list[np.ndarray], duration_ms: int = 200) -> None:
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:], duration=duration_ms, loop=0
    )


def render_point_cloud_raster(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    image_size: int = 512,
    point_size: float = 2.0,
    elev: float = 25.0,
    azim: float = 45.0,
    background: float = 1.0,
    title: str | None = None,  # accepted for API parity; rasterizer draws no text
) -> np.ndarray:
    """Z-buffer point splatting — the numpy equivalent of the reference's
    PyTorch3D rasterizer path (ref render.py:219-292). ~50x faster than the
    matplotlib 3D scatter for large clouds and with correct occlusion.

    Orthographic camera at (elev, azim); each point splats a point_size-px
    square resolved by nearest depth (painter's order via argsort).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    H = W = int(image_size)
    img = np.full((H, W, 3), background, np.float32)
    if len(pts) == 0:
        return (img * 255).astype(np.uint8)
    if colors is None:
        colors = np.tile(part_colormap()[0], (len(pts), 1))
    colors = np.asarray(colors, np.float32).reshape(-1, 3)
    if colors.max() > 1.0:
        colors = colors / 255.0

    # camera basis from elev/azim (y-up view coordinates)
    az, el = np.radians(azim), np.radians(elev)
    fwd = -np.array([
        np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)
    ])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    c = pts.mean(0)
    centered = pts - c
    x = centered @ right
    y = centered @ up
    z = centered @ fwd                    # larger = farther along view dir
    r = max(float(np.abs(np.stack([x, y])).max()), 1e-9) * 1.05
    px = ((x / r) * 0.5 + 0.5) * (W - 1)
    py = (0.5 - (y / r) * 0.5) * (H - 1)

    # true z-buffer: expand every point to its splat pixels, then keep the
    # nearest depth per pixel (lexsort by (pixel, depth), first wins)
    half = max(int(round(point_size / 2)), 0)
    offs = [(dy, dx) for dy in range(-half, half + 1) for dx in range(-half, half + 1)]
    pix_list, z_list, col_list = [], [], []
    for dy, dx in offs:
        ix = np.clip(np.round(px + dx).astype(np.int64), 0, W - 1)
        iy = np.clip(np.round(py + dy).astype(np.int64), 0, H - 1)
        pix_list.append(iy * W + ix)
        z_list.append(z)
        col_list.append(colors)
    pix = np.concatenate(pix_list)
    zz = np.concatenate(z_list)
    cc = np.concatenate(col_list)
    order = np.lexsort((zz, pix))
    pix_s = pix[order]
    first = np.ones(len(pix_s), bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    img.reshape(-1, 3)[pix_s[first]] = cc[order][first]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def estimate_normals(points: np.ndarray, k: int = 12) -> np.ndarray:
    """(N,3) unit normals from k-NN covariance (smallest eigenvector)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    n = len(pts)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    k = min(k, n)
    _, idx = cKDTree(pts).query(pts, k=k)
    nb = pts[idx]
    centered = nb - nb.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    # eigh is ascending: the first eigenvector is the surface normal
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]
    return normals.astype(np.float32)


def render_point_cloud_shaded(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    image_size: int = 512,
    point_size: float = 3.0,
    elev: float = 25.0,
    azim: float = 45.0,
    background: float = 1.0,
    normals: np.ndarray | None = None,
    ground_shadow: bool = True,
    supersample: int = 2,
    title: str | None = None,  # API parity; no text in the raster path
) -> np.ndarray:
    """Offline-quality shaded render — the role of the reference's Mitsuba
    path tracer (ref render.py:295-402), dependency-free:

      - per-point normals (k-NN PCA) flipped toward the camera,
      - two-light Lambertian + Blinn-Phong shading with depth cueing,
      - screen-space ambient occlusion from the splat z-buffer,
      - a ground plane at min-z receiving a soft blurred shadow,
      - 2x supersampled disk splats, box-downsampled (anti-aliasing).

    Orthographic camera as in render_point_cloud_raster. Slower than the
    plain raster (normal estimation is O(N log N)); meant for docs/report
    artifacts, not per-batch callbacks.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    ss = max(int(supersample), 1)
    H = W = int(image_size) * ss
    if len(pts) == 0:
        img = np.full((H, W, 3), background, np.float32)
        return (img[::ss, ::ss] * 255).astype(np.uint8)
    if colors is None:
        colors = np.tile(part_colormap()[0], (len(pts), 1))
    colors = np.asarray(colors, np.float32).reshape(-1, 3)
    if colors.max() > 1.0:
        colors = colors / 255.0
    if normals is None:
        normals = estimate_normals(pts)

    # camera basis (shared with the raster path)
    az, el = np.radians(azim), np.radians(elev)
    fwd = -np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(right, fwd)
    c = pts.mean(0)
    centered = pts - c
    x, y, z = centered @ right, centered @ up, centered @ fwd
    r = max(float(np.abs(np.stack([x, y])).max()), 1e-9) * 1.15
    px = ((x / r) * 0.5 + 0.5) * (W - 1)
    py = (0.5 - (y / r) * 0.5) * (H - 1)

    # ---- shading (per point) -------------------------------------------------
    nrm = np.asarray(normals, np.float64)
    flip = (nrm @ fwd) > 0            # orient toward the camera
    nrm = np.where(flip[:, None], -nrm, nrm)
    key = np.array([-0.5, 0.35, 0.85])    # world-frame key light
    key /= np.linalg.norm(key)
    fill = -fwd                            # headlight fill
    lam = 0.62 * np.maximum(nrm @ key, 0.0) + 0.18 * np.maximum(nrm @ fill, 0.0)
    halfv = key - fwd
    halfv /= max(np.linalg.norm(halfv), 1e-9)
    spec = 0.25 * np.maximum(nrm @ halfv, 0.0) ** 24
    depth01 = (z - z.min()) / max(np.ptp(z), 1e-9)
    cue = 1.0 - 0.25 * depth01            # farther = slightly dimmer
    shade = (0.30 + lam)[:, None] * colors * cue[:, None] + spec[:, None]

    # ---- z-buffer disk splats --------------------------------------------------
    half = max(int(round(point_size * ss / 2)), 1)
    zbuf = np.full(H * W, np.inf)
    img = np.full((H * W, 3), -1.0, np.float32)   # -1 marks empty
    offs = [
        (dy, dx)
        for dy in range(-half, half + 1)
        for dx in range(-half, half + 1)
        if dy * dy + dx * dx <= half * half
    ]
    pix_list, z_list = [], []
    for dy, dx in offs:
        ix = np.clip(np.round(px + dx).astype(np.int64), 0, W - 1)
        iy = np.clip(np.round(py + dy).astype(np.int64), 0, H - 1)
        pix_list.append(iy * W + ix)
        z_list.append(z)
    pix = np.concatenate(pix_list)
    zz = np.concatenate(z_list)
    cc = np.concatenate([shade] * len(offs))
    order = np.lexsort((zz, pix))
    pix_s = pix[order]
    first = np.ones(len(pix_s), bool)
    first[1:] = pix_s[1:] != pix_s[:-1]
    img[pix_s[first]] = cc[order][first]
    zbuf[pix_s[first]] = zz[order][first]

    # ---- ground plane + soft shadow -------------------------------------------
    if ground_shadow:
        z0 = pts[:, 2].min() - 1e-3
        # ray through pixel (ortho): p(s) = c + xv*right + yv*up + s*fwd
        u_px = (np.arange(W) / (W - 1) * 2.0 - 1.0) * r
        v_px = (0.5 - np.arange(H) / (H - 1)) * 2.0 * r
        XV, YV = np.meshgrid(u_px, v_px)
        if abs(fwd[2]) > 1e-6:
            s_hit = (z0 - (c[2] + XV * right[2] + YV * up[2])) / fwd[2]
            wx = c[0] + XV * right[0] + YV * up[0] + s_hit * fwd[0]
            wy = c[1] + XV * right[1] + YV * up[1] + s_hit * fwd[1]
            # soft shadow: blurred 2D density of the cloud footprint
            gx = np.clip(((pts[:, 0] - wx.min()) / max(np.ptp(wx), 1e-9) * 127), 0, 127).astype(int)
            gy = np.clip(((pts[:, 1] - wy.min()) / max(np.ptp(wy), 1e-9) * 127), 0, 127).astype(int)
            dens = np.zeros((128, 128))
            np.add.at(dens, (gy, gx), 1.0)
            dens = _box_blur(dens, 6)
            dens = dens / max(dens.max(), 1e-9)
            sx = np.clip(((wx - wx.min()) / max(np.ptp(wx), 1e-9) * 127), 0, 127).astype(int)
            sy = np.clip(((wy - wy.min()) / max(np.ptp(wy), 1e-9) * 127), 0, 127).astype(int)
            shadow = dens[sy, sx]
            plane_col = background * (1.0 - 0.45 * shadow)
            visible = (s_hit.reshape(-1) < zbuf) & (s_hit.reshape(-1) > 0)
            empty = img[:, 0] < 0
            fillpix = visible & empty
            img[fillpix] = plane_col.reshape(-1, 1)[fillpix]

    img[img[:, 0] < 0] = background
    img = img.reshape(H, W, 3)

    # ---- SSAO from the z-buffer ------------------------------------------------
    zb = zbuf.reshape(H, W).copy()
    filled = np.isfinite(zb)
    if filled.any():
        zmax = zb[filled].max()
        zb[~filled] = zmax
        mean_z = _box_blur(zb, max(2 * ss, 2))
        occl = np.clip((mean_z - zb) / max(np.ptp(zb[filled]), 1e-9) * -6.0, 0.0, 0.6)
        img *= (1.0 - occl[..., None] * filled[..., None])

    # box-downsample the supersampled buffer
    if ss > 1:
        img = img.reshape(H // ss, ss, W // ss, ss, 3).mean(axis=(1, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _box_blur(a: np.ndarray, radius: int) -> np.ndarray:
    """Separable box blur via cumulative sums (O(HW))."""
    if radius <= 0:
        return a
    for axis in (0, 1):
        n = a.shape[axis]
        cs = np.cumsum(a, axis=axis)
        cs = np.concatenate([np.zeros_like(np.take(cs, [0], axis=axis)), cs], axis=axis)
        idx_hi = np.minimum(np.arange(n) + radius + 1, n)
        idx_lo = np.maximum(np.arange(n) - radius, 0)
        a = (np.take(cs, idx_hi, axis=axis) - np.take(cs, idx_lo, axis=axis))
        a = a / (idx_hi - idx_lo).reshape([-1 if ax == axis else 1 for ax in (0, 1)])
    return a


def visualize_point_clouds(
    points: np.ndarray,
    part_ids: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    renderer: str = "matplotlib",
    **kw,
) -> np.ndarray | None:
    """Dispatcher mirroring reference render.py:405-427: 'matplotlib'
    (3D scatter), 'raster' (z-buffer splatting, the pytorch3d-rasterizer
    equivalent), 'shaded' (lit/AO/shadow offline mode, the Mitsuba-tier
    slot), 'none' stub."""
    if renderer == "none":
        return None
    if colors is None and part_ids is not None:
        colors = part_ids_to_colors(part_ids)
    if renderer == "raster":
        return render_point_cloud_raster(points, colors, **kw)
    if renderer == "shaded":
        return render_point_cloud_shaded(points, colors, **kw)
    return render_point_cloud(points, colors, **kw)
