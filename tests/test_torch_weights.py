"""Weights carried from rap_tpu into the port.

Every committed .npz loads with the layer count its sidecar gives (the JSON
files beside the teachers; configs/synth_student.yaml for reflow_student),
bf16 bits decode exactly as rap_tpu's loader decodes them, and the stacked
layer arrays split into per-layer tensors without changing a value.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from rap_tpu.models import DiTConfig as JaxDiTConfig
from rap_tpu.models.dit import init_dit_params
from rap_tpu.train.checkpoint import load_params_npz as jax_load_npz
from rap_tpu_torch.models.dit import attention_bound2
from rap_tpu_torch.weights import load_params_npz, params_from_jax, read_npz

REPO = Path(__file__).resolve().parents[1]
CKPTS = REPO / "demo_data" / "ckpts"


def _expected_layers(name: str) -> int:
    sidecar = CKPTS / f"{name}.json"
    if sidecar.exists():
        return json.loads(sidecar.read_text())["layers"]
    cfg = yaml.safe_load((REPO / "configs" / "synth_student.yaml").read_text())
    assert cfg["checkpoint"] == f"demo_data/ckpts/{name}.npz"
    return cfg["model"]["num_layers"]


@pytest.mark.parametrize("name", ["teacher3_last", "teacher5_mv", "teacher12", "reflow_student"])
def test_committed_npz_loads_with_its_layer_count(name):
    params = load_params_npz(CKPTS / f"{name}.npz", device="cpu")
    L = _expected_layers(name)
    assert len(params["layers"]) == L
    D = params["anchor_emb"].shape[1]
    for lp in params["layers"]:
        assert lp["self_qkv"]["kernel"].shape == (D, 3 * D)
        assert lp["self_qkv"]["kernel"].dtype == torch.bfloat16
        assert lp["self_prenorm"]["ada_linear"]["kernel"].dtype == torch.float32
        assert lp["ff_out"]["kernel"].shape == (4 * D, D)
        for prefix in ("self", "global"):
            b = lp[f"{prefix}_bound2"]
            assert isinstance(b, float) and np.isfinite(b) and b > 0
    assert params["final_mlp"]["fc3"]["kernel"].shape == (D // 2, 3)


def test_bf16_decode_matches_rap_tpu():
    ours = read_npz(CKPTS / "teacher3_last.npz")
    theirs = jax_load_npz(CKPTS / "teacher3_last.npz")
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v, np.float32), err_msg=k)


def test_teacher3_guard_bounds():
    """6 of teacher3's 12 attention calls are over SAFE_BOUND2 = 60."""
    params = load_params_npz(CKPTS / "teacher3_last.npz", device="cpu")
    over = [(i, p) for i, lp in enumerate(params["layers"]) for p in ("self", "global")
            if lp[f"{p}_bound2"] > 60.0]
    assert over == [(0, "self"), (0, "global"), (1, "self"), (1, "global"),
                    (2, "self"), (4, "global")]


def test_params_from_jax_splits_layers_exactly():
    cfg = JaxDiTConfig(embed_dim=64, num_layers=3, num_heads=2, local_feat_dim=8)
    jp = jax.tree.map(np.asarray, init_dit_params(jax.random.key(0), cfg))
    tp = params_from_jax(jp)
    assert len(tp["layers"]) == 3
    for i, lp in enumerate(tp["layers"]):
        np.testing.assert_array_equal(lp["self_qkv"]["kernel"].numpy(),
                                      jp["layers"]["self_qkv"]["kernel"][i])
        np.testing.assert_array_equal(lp["global_prenorm"]["time_mlp2"]["bias"].numpy(),
                                      jp["layers"]["global_prenorm"]["time_mlp2"]["bias"][i])
        assert lp["self_bound2"] == pytest.approx(
            attention_bound2(torch.tensor(jp["layers"]["self_q_gamma"][i]),
                             torch.tensor(jp["layers"]["self_k_gamma"][i])))
    np.testing.assert_array_equal(tp["emb_proj"]["kernel"].numpy(), jp["emb_proj"]["kernel"])
