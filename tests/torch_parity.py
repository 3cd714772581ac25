"""Helpers shared by the parity tests of rap_tpu_torch against rap_tpu.

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; both run on the CPU (JAX's Pallas kernels in interpret mode,
the port's wrappers through their plain versions).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from rap_tpu_torch.core.batch import TENSOR_FIELDS, PartBatch
from rap_tpu_torch.weights import params_from_jax


def batch_to_torch(jb) -> PartBatch:
    """numpy copy of a rap_tpu PartBatch -> the port's batch on the CPU."""
    arrays = {f: np.asarray(getattr(jb, f)) for f in TENSOR_FIELDS
              if getattr(jb, f) is not None}
    return PartBatch.from_numpy(arrays, jb.no_padding, device="cpu")


def params_to_torch(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def tiny_pallas_models(seed: int = 1, embed_dim: int = 128, num_heads: int = 2):
    """(jax cfg, port cfg, jax params, port params): D=128, 2 layers, 2 heads
    (or ``embed_dim`` and ``num_heads``), fp32, the fused branch on both
    sides where the head width is below 128 (``attn_impl="pallas"``: rap_tpu's
    Pallas kernels in interpret mode, the port's plain twins), qk gains
    near 1 except layer 0's global attention, raised past the guard bound so
    that both attention variants run."""
    import jax.numpy as jnp

    from rap_tpu.models import DiTConfig as JaxDiTConfig
    from rap_tpu.models.dit import init_dit_params
    from rap_tpu_torch.models.config import DiTConfig

    jcfg = JaxDiTConfig(embed_dim=embed_dim, num_layers=2, num_heads=num_heads,
                        compute_dtype=jnp.float32, attn_impl="pallas", ff_impl="pallas")
    tcfg = DiTConfig(embed_dim=embed_dim, num_layers=2, num_heads=num_heads,
                     compute_dtype=torch.float32, attn_impl="pallas", ff_impl="pallas")
    jp = init_dit_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(0)
    layers = dict(jp["layers"])
    for name in ("self_q_gamma", "self_k_gamma", "global_q_gamma", "global_k_gamma"):
        layers[name] = jnp.asarray(
            1 + 0.1 * rng.standard_normal((2, num_heads, embed_dim // num_heads)), jnp.float32)
    layers["global_q_gamma"] = layers["global_q_gamma"].at[0].multiply(3.0)
    layers["global_k_gamma"] = layers["global_k_gamma"].at[0].multiply(3.0)
    jp = {**jp, "layers": layers}
    return jcfg, tcfg, jp, params_to_torch(jp)


def jax_flat(tree) -> dict[str, np.ndarray]:
    """A rap_tpu parameter-shaped tree (stacked ``layers``) as {port path:
    numpy array}, with the port's per-layer paths ("layers/<i>/...")."""
    out = {}

    def walk(node, prefix, layer=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/", layer)
            return
        a = np.asarray(node)
        if layer is None:
            out[prefix[:-1]] = a
        else:
            for i in range(a.shape[0]):
                out[f"layers/{i}/{prefix[len('layers/'):-1]}"] = a[i]

    for k, v in tree.items():
        walk(v, f"{k}/", layer=(k == "layers") or None)
    return out


REPO_ROOT = Path(__file__).resolve().parents[1]
WORKER = REPO_ROOT / "tests" / "torch_parallel_worker.py"


def run_world(spec: dict, world: int, workdir: Path, timeout: float = 300) -> list[dict]:
    """Run ``spec``'s tasks (tests/torch_parallel_worker.py) in a gloo world
    of ``world`` CPU processes joined on a file store in ``workdir``; each
    process gets its own timeout. Returns each rank's results."""
    return run_worlds([(spec, world, workdir)], timeout)[0]


def run_worlds(jobs, timeout: float = 300) -> list[list[dict]]:
    """``run_world`` for several (spec, world, workdir) at once."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    for spec, world, workdir in jobs:
        workdir.mkdir(parents=True, exist_ok=True)
        torch.save(spec, workdir / "spec.pt")
        procs += [(r, world, subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(workdir)], cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
            for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (r, world, p), (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{so[-2000:]}\n{se[-6000:]}"
    return [[torch.load(workdir / f"out_{r}.pt", weights_only=False) for r in range(world)]
            for _, world, workdir in jobs]
