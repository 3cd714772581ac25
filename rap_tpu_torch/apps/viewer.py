"""Offline result and sample viewers, headless (a copy of
rap_tpu/apps/viewer.py, host numpy; the port imports nothing of rap_tpu).

The counterpart of the reference's Open3D viewers of registered clouds and
of sample features: load sample or result folders (``apps.sample``'s
``eval.save_results`` artifacts, ``apps.demo``'s output folder), apply the
estimated per-part transforms, and render part-index or PCA colourings to
PNG (matplotlib Agg, or the raster / shaded renderers), orbit GIFs and
before/after panels, or export an interactive HTML viewer
(``apps.html_viewer``). ``--show`` opens a matplotlib window.

    python -m rap_tpu_torch.apps.viewer results --results-dir results/demo -o viz/
    python -m rap_tpu_torch.apps.viewer samples --data-dir dataset/ -o viz/ [--pca]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import logging
import re
import sys
from pathlib import Path

import numpy as np

from ..utils import ply as plyio
from ..utils.render import (
    part_ids_to_colors,
    pca_colors,
    render_point_cloud,
    save_gif,
    save_image,
    visualize_point_clouds,
)

logger = logging.getLogger("rap_tpu_torch.viewer")


# ---------------------------------------------------------------------------
# results browser (registered point clouds)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResultSample:
    """One evaluated sample: part clouds + the estimated per-part poses.

    ``registered`` is True for both supported producers (the evaluator saves
    predictions, the demo saves transformed clouds) — applying the saved
    poses to these would double-transform; poses belong on INPUT clouds
    (pass ``input_dir`` to the browser, like the reference viewer which
    takes the dataset dir alongside the results dir)."""

    name: str
    parts: list[np.ndarray]                 # part clouds (see `registered`)
    part_indices: list[int]                 # part index per cloud (-1 = merged)
    transforms: dict[int, np.ndarray] | None  # part index -> (4,4)
    registered: bool = True


def _part_index(f: Path) -> int:
    m = re.search(r"part(\d+)", f.name)
    return int(m.group(1)) if m else -1


def _sorted_by_part(files) -> list[Path]:
    """NUMERIC part order — lexicographic sorting breaks at part10 vs part2
    (the evaluator's pose files are zero-padded but demo outputs are not)."""
    return sorted(files, key=lambda f: (_part_index(f), f.name))


def _load_transform_files(d: Path, pattern: str) -> dict[int, np.ndarray]:
    out = {}
    for f in d.glob(pattern):
        idx = _part_index(f)
        if idx >= 0:
            out[idx] = np.loadtxt(f)
    return out


def load_result_sample(sample_dir, generation: str | int = 0) -> ResultSample:
    """Load one result-dir sample.

    Supports both producers:
      - apps/sample.py evaluator output: ``generation_<g>/`` with
        ``part{p:02d}_pose.txt`` (+ merged_pred.ply / part{p}_pred.ply);
      - apps/demo.py output: ``registered/*.ply`` + ``part{p}_transform.txt``.
    """
    sample_dir = Path(sample_dir)
    gen_dir = sample_dir / f"generation_{generation}"
    if gen_dir.is_dir():
        poses = _load_transform_files(gen_dir, "part*_pose.txt")
        part_files = _sorted_by_part(gen_dir.glob("part*_pred.ply"))
        if part_files:
            parts = [plyio.read_ply(f)["points"] for f in part_files]
            idxs = [_part_index(f) for f in part_files]
        else:
            merged = gen_dir / "merged_pred.ply"
            parts = [plyio.read_ply(merged)["points"]] if merged.is_file() else []
            idxs = [-1] * len(parts)
        return ResultSample(sample_dir.name, parts, idxs, poses or None)
    reg_dir = sample_dir / "registered"
    if reg_dir.is_dir():
        part_files = _sorted_by_part(reg_dir.glob("*.ply"))
        parts = [plyio.read_ply(f)["points"] for f in part_files]
        idxs = [_part_index(f) for f in part_files]
        poses = _load_transform_files(sample_dir, "part*_transform.txt")
        return ResultSample(sample_dir.name, parts, idxs, poses or None)
    raise FileNotFoundError(f"no results found under {sample_dir}")


def discover_result_samples(results_dir) -> list[Path]:
    """Find sample dirs under an apps/sample.py or demo.py output tree."""
    root = Path(results_dir)
    hits = sorted(
        {Path(p).parent for p in glob.glob(str(root / "**" / "generation_*"), recursive=True)}
    )
    if not hits and (root / "registered").is_dir():
        hits = [root]
    return hits


def apply_estimated_poses(
    parts: list[np.ndarray],
    part_indices: list[int],
    transforms: dict[int, np.ndarray],
) -> list[np.ndarray]:
    """Apply per-part 4x4 transforms, matched BY PART INDEX (the reference
    viewer's core op: visualize_registered_pointclouds.py applies result-dir
    poses to inputs). Parts without a saved pose keep identity (warned)."""
    out = []
    for p, idx in zip(parts, part_indices):
        T = transforms.get(idx)
        if T is None:
            logger.warning("no saved pose for part %d; leaving it in place", idx)
            out.append(p)
        else:
            out.append(p @ T[:3, :3].T + T[:3, 3])
    return out


def render_result_sample(
    sample: ResultSample,
    out_dir,
    apply_poses: bool = False,
    input_parts: list[np.ndarray] | None = None,
    input_indices: list[int] | None = None,
    image_size: int = 512,
    views=((25, 45), (25, 135)),
    renderer: str = "matplotlib",
    orbit: int = 0,
    compare: bool = False,
) -> list[Path]:
    """Render part-colored PNGs of a result sample; returns written paths.

    ``apply_poses`` needs UNREGISTERED input clouds (``input_parts``); the
    saved result clouds are already registered, so applying the saved poses
    to them would double-transform — refused with a warning.

    ``renderer``: matplotlib | raster | shaded (utils/render.py modes).
    ``orbit``: >0 writes an N-frame azimuth-sweep GIF — the headless
    replacement for the reference viewer's interactive camera orbit
    (visualize_registered_pointclouds.py drag-to-rotate).
    ``compare``: with ``input_parts``, writes a side-by-side
    input | result panel (the reference viewer's before/after toggle)."""
    parts = sample.parts
    if apply_poses and sample.transforms:
        if input_parts is not None:
            idxs = (
                input_indices
                if input_indices is not None
                else list(range(len(input_parts)))
            )
            parts = apply_estimated_poses(input_parts, idxs, sample.transforms)
        elif sample.registered:
            logger.warning(
                "%s: result clouds are already registered; --apply-poses "
                "needs --input-dir with the original input clouds", sample.name,
            )
        else:
            parts = apply_estimated_poses(
                parts, sample.part_indices, sample.transforms
            )
    merged = np.concatenate(parts) if parts else np.zeros((0, 3))
    ids = np.concatenate(
        [np.full(len(p), i) for i, p in enumerate(parts)]
    ) if parts else np.zeros(0, int)
    colors = part_ids_to_colors(ids)
    out_dir = Path(out_dir)
    written = []

    def _render(pts, cols, elev, azim, title):
        return visualize_point_clouds(
            pts, colors=cols, renderer=renderer, image_size=image_size,
            elev=elev, azim=azim, title=title,
        )

    for elev, azim in views:
        img = _render(merged, colors, elev, azim, sample.name)
        p = out_dir / f"{sample.name}_e{elev}_a{azim}.png"
        save_image(p, img)
        written.append(p)
    if orbit > 0 and len(merged):
        frames = [
            _render(merged, colors, views[0][0], a, sample.name)
            for a in np.linspace(0.0, 360.0, orbit, endpoint=False)
        ]
        p = out_dir / f"{sample.name}_orbit.gif"
        save_gif(p, frames, duration_ms=120)
        written.append(p)
    if compare and input_parts is not None:
        in_merged = np.concatenate(input_parts)
        in_ids = np.concatenate(
            [np.full(len(q), i) for i, q in enumerate(input_parts)]
        )
        left = _render(in_merged, part_ids_to_colors(in_ids),
                       views[0][0], views[0][1], "input")
        right = _render(merged, colors, views[0][0], views[0][1], "result")
        h = min(left.shape[0], right.shape[0])
        panel = np.concatenate([left[:h], right[:h]], axis=1)
        p = out_dir / f"{sample.name}_compare.png"
        save_image(p, panel)
        written.append(p)
    return written


def browse_results(
    results_dir, out_dir, apply_poses: bool = False, limit: int = 0,
    generation: str | int = 0, input_dir=None,
    renderer: str = "matplotlib", orbit: int = 0, compare: bool = False,
) -> list[Path]:
    """Headless batch render of every sample in a results dir.

    ``input_dir``: folder of original (unregistered) input PLYs; with
    ``apply_poses`` the saved estimated poses are applied to those clouds,
    matching the reference viewer's dataset-dir + results-dir pairing."""
    samples = discover_result_samples(results_dir)
    if limit:
        samples = samples[:limit]
    input_parts = input_indices = None
    if input_dir is not None:
        files = _sorted_by_part(Path(input_dir).glob("*.ply"))
        input_parts = [plyio.read_ply(f)["points"] for f in files]
        idxs = [_part_index(f) for f in files]
        # unnumbered input files map positionally onto sorted pose indices
        input_indices = (
            idxs if all(i >= 0 for i in idxs) else list(range(len(files)))
        )
    written = []
    for sd in samples:
        try:
            rs = load_result_sample(sd, generation=generation)
        except FileNotFoundError as e:
            logger.warning("%s", e)
            continue
        written += render_result_sample(
            rs, out_dir, apply_poses=apply_poses,
            input_parts=input_parts, input_indices=input_indices,
            renderer=renderer, orbit=orbit, compare=compare,
        )
    logger.info("rendered %d images to %s", len(written), out_dir)
    return written


# ---------------------------------------------------------------------------
# sample-folder browser (features / PCA coloring)
# ---------------------------------------------------------------------------

def load_sample_folder(sample_dir):
    """Load a training-sample folder: part PLYs + features_<part>.npy sidecars."""
    sample_dir = Path(sample_dir)
    parts, feats = [], []
    for f in sorted(sample_dir.glob("*.ply")):
        parts.append(plyio.read_ply(f)["points"])
        side = sample_dir / f"features_{f.stem}.npy"
        feats.append(np.load(side) if side.exists() else None)
    return parts, feats


def render_sample_folder(
    sample_dir, out_dir, pca: bool = True, image_size: int = 512,
    pca_basis: np.ndarray | None = None,
):
    """Render a sample folder: part-index coloring + optional PCA features.
    Returns (written paths, pca basis) — thread the basis through for
    consistent coloring across samples (ref freezes it from the first)."""
    sample_dir = Path(sample_dir)
    parts, feats = load_sample_folder(sample_dir)
    if not parts:
        return [], pca_basis
    merged = np.concatenate(parts)
    ids = np.concatenate([np.full(len(p), i) for i, p in enumerate(parts)])
    out_dir = Path(out_dir)
    written = []
    img = render_point_cloud(
        merged, part_ids_to_colors(ids), image_size=image_size,
        title=f"{sample_dir.name} (parts)",
    )
    p = out_dir / f"{sample_dir.name}_parts.png"
    save_image(p, img)
    written.append(p)
    if pca and all(f is not None for f in feats):
        allf = np.concatenate(feats)
        colors, pca_basis = pca_colors(allf, pca_basis)
        img = render_point_cloud(
            merged, colors, image_size=image_size,
            title=f"{sample_dir.name} (PCA features)",
        )
        p = out_dir / f"{sample_dir.name}_pca.png"
        save_image(p, img)
        written.append(p)
    return written, pca_basis


def browse_samples(data_dir, out_dir, pca: bool = True, limit: int = 0):
    root = Path(data_dir)
    sample_dirs = sorted(
        d for d in root.iterdir() if d.is_dir() and list(d.glob("*.ply"))
    )
    if limit:
        sample_dirs = sample_dirs[:limit]
    written = []
    basis = None
    for sd in sample_dirs:
        w, basis = render_sample_folder(sd, out_dir, pca=pca, pca_basis=basis)
        written += w
    logger.info("rendered %d images to %s", len(written), out_dir)
    return written


# ---------------------------------------------------------------------------
# interactive HTML export (the headless answer to the reference's Open3D GUIs)
# ---------------------------------------------------------------------------

def export_results_html(
    results_dir, out_html, input_dir=None, generation: str | int = 0,
    limit: int = 0, max_points: int = 80_000,
) -> Path:
    """Bundle a results dir into one self-contained interactive HTML viewer
    (apps/html_viewer.py). With ``input_dir``, each sample carries BOTH the
    raw input clouds and the estimated-pose-applied state, toggleable in the
    browser ('g') — the reference viewer's before/after interaction
    (visualize_registered_pointclouds.py), with no display server needed."""
    from .html_viewer import build_sample, export_html

    dirs = discover_result_samples(results_dir)
    if limit:
        dirs = dirs[:limit]
    input_parts = input_indices = None
    if input_dir is not None:
        files = _sorted_by_part(Path(input_dir).glob("*.ply"))
        input_parts = [plyio.read_ply(f)["points"] for f in files]
        idxs = [_part_index(f) for f in files]
        input_indices = (
            idxs if all(i >= 0 for i in idxs) else list(range(len(files)))
        )
    html_samples = []
    basis = None
    for sd in dirs:
        try:
            rs = load_result_sample(sd, generation=generation)
        except FileNotFoundError as e:
            logger.warning("%s", e)
            continue
        if input_parts is not None and rs.transforms:
            posed = apply_estimated_poses(
                input_parts, input_indices, rs.transforms
            )
            s, basis = build_sample(
                rs.name, input_parts, parts_alt=posed,
                max_points=max_points, pca_basis=basis,
            )
        else:
            s, basis = build_sample(
                rs.name, rs.parts, max_points=max_points, pca_basis=basis
            )
        html_samples.append(s)
    out = export_html(html_samples, out_html)
    logger.info("wrote interactive viewer: %s (%d samples)", out, len(html_samples))
    return out


def export_samples_html(
    data_dir, out_html, limit: int = 0, max_points: int = 80_000
) -> Path:
    """Bundle training-sample folders (parts + feature sidecars) into the
    interactive HTML viewer with part/PCA/height color modes (the reference's
    visualize_sample_features.py surface)."""
    from .html_viewer import build_sample, export_html

    root = Path(data_dir)
    sample_dirs = sorted(
        d for d in root.iterdir() if d.is_dir() and list(d.glob("*.ply"))
    )
    if limit:
        sample_dirs = sample_dirs[:limit]
    html_samples = []
    basis = None
    for sd in sample_dirs:
        parts, feats = load_sample_folder(sd)
        if not parts:
            continue
        s, basis = build_sample(
            sd.name, parts, features=feats, max_points=max_points,
            pca_basis=basis,
        )
        html_samples.append(s)
    out = export_html(html_samples, out_html)
    logger.info("wrote interactive viewer: %s (%d samples)", out, len(html_samples))
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("results", help="browse a results dir")
    r.add_argument("--results-dir", required=True)
    r.add_argument("-o", "--output", default="viewer_output")
    r.add_argument("--apply-poses", action="store_true")
    r.add_argument(
        "--input-dir", default=None,
        help="folder of original input PLYs to apply the estimated poses to",
    )
    r.add_argument("--generation", default="0")
    r.add_argument("--limit", type=int, default=0)
    r.add_argument("--renderer", default="matplotlib",
                   choices=["matplotlib", "raster", "shaded"])
    r.add_argument("--orbit", type=int, default=0, metavar="FRAMES",
                   help="write an azimuth-orbit GIF per sample (headless "
                        "equivalent of the reference viewer's camera orbit)")
    r.add_argument("--compare", action="store_true",
                   help="side-by-side input|result panel (needs --input-dir)")
    r.add_argument("--html", default=None, metavar="FILE",
                   help="ALSO export a self-contained interactive WebGL "
                        "viewer (orbit/zoom/pan, pose toggle) to FILE")
    s = sub.add_parser("samples", help="browse training-sample folders")
    s.add_argument("--data-dir", required=True)
    s.add_argument("-o", "--output", default="viewer_output")
    s.add_argument("--no-pca", dest="pca", action="store_false")
    s.add_argument("--limit", type=int, default=0)
    s.add_argument("--html", default=None, metavar="FILE",
                   help="ALSO export the interactive WebGL viewer to FILE")
    args = ap.parse_args(argv)
    if args.mode == "results":
        browse_results(
            args.results_dir, args.output, apply_poses=args.apply_poses,
            limit=args.limit, generation=args.generation,
            input_dir=args.input_dir, renderer=args.renderer,
            orbit=args.orbit, compare=args.compare,
        )
        if args.html:
            export_results_html(
                args.results_dir, args.html, input_dir=args.input_dir,
                generation=args.generation, limit=args.limit,
            )
    else:
        browse_samples(args.data_dir, args.output, pca=args.pca, limit=args.limit)
        if args.html:
            export_samples_html(args.data_dir, args.html, limit=args.limit)
    return 0


if __name__ == "__main__":
    main()
