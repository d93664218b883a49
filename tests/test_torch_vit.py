"""The port's InternVL vision tower and projector (models/vit.py)
against the JAX package's, on the CPU, at the JAX tests' tiny widths
(64 wide, 2 layers, 4 heads, MLP 128, 56-pixel tiles of patch 14: 16
patches, 4 tokens a tile after the 0.5 pixel shuffle).

patchify and pixel_shuffle move values without arithmetic, so they are
held bit-equal on integer ramps. The tower is held within a stated share
of the output range: the two packages run the same dtypes product by
product (bf16 layer weights and inputs, f32 bias adds, f32 scores,
softmax and P.V, f32 norms and projector), but their CPU matmuls sum in
different orders and each bf16 rounding may then fall the other way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerserve_tpu.models import vit as jvit
from powerserve_tpu_torch.models import vit
from powerserve_tpu_torch.tools.synthetic import random_vision_state
from torch_threads import one_torch_thread  # noqa: F401

# measured 5e-7 of the range through the two layers and the projector
# (f32 sums in another order); 1e-4 leaves room for other CPUs' BLAS
REL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _state(seed: int, bias: bool = True, layer_scale: bool = True) -> dict:
    sd = random_vision_state("tiny-vit", 64, seed)
    for k in list(sd):
        if (not bias and "_proj.bias" in k) or (
                not layer_scale and "lambda_" in k):
            del sd[k]
    return sd


def _jax_params(sd):
    return jvit.vision_params_from_hf(sd, 2, 4, 14, 1e-6, 0.5)


def _tree(jp) -> dict:
    """JAX VisionParams -> a dict of numpy arrays (layers a dict too)."""
    out = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    out = {k: (v if isinstance(v, (int, float)) else np.asarray(v))
           for k, v in out.items() if k != "layers"}
    out["layers"] = {f.name: (None if getattr(jp.layers, f.name) is None
                              else np.asarray(getattr(jp.layers, f.name)))
                     for f in dataclasses.fields(jp.layers)}
    return out


def test_patchify_bit_equal_on_a_ramp():
    px = np.arange(2 * 3 * 56 * 56, dtype=np.float32).reshape(2, 3, 56, 56)
    want = np.asarray(jvit.patchify(jnp.asarray(px), 14))
    got = vit.patchify(torch.from_numpy(px), 14).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 32, 32, 16)])
def test_pixel_shuffle_bit_equal_on_a_ramp(shape):
    f = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = np.asarray(jvit.pixel_shuffle(jnp.asarray(f), 0.5))
    got = vit.pixel_shuffle(torch.from_numpy(f), 0.5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias,layer_scale", [(True, True), (False, False)],
                         ids=["bias-scale", "plain"])
def test_vision_tower_matches_jax(bias, layer_scale):
    sd = _state(3, bias, layer_scale)
    jp = _jax_params(sd)
    px = np.random.default_rng(0).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    want = np.asarray(jvit.vision_encode(jp, jnp.asarray(px)))
    for vp in (vit.vision_params_from_numpy(_tree(jp), device="cpu"),
               vit.vision_params_from_hf(sd, 2, 4, 14, 1e-6, 0.5,
                                         device="cpu")):
        assert vp.layers[0].qkv_w.dtype == torch.bfloat16
        assert (vp.layers[0].qkv_b is None) == (not bias)
        got = vit.vision_encode(vp, torch.from_numpy(px)).numpy()
        assert got.shape == want.shape == (2, 16, 64)
        assert _rel(got, want) < REL


def test_projector_and_encode_images_match_jax():
    sd = _state(4)
    jp = _jax_params(sd)
    vp = vit.vision_params_from_numpy(_tree(jp), device="cpu")
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((3, 16, 64)).astype(np.float32)
    want = np.asarray(jvit.project_image_features(jp, jnp.asarray(feat)))
    got = vit.project_image_features(vp, torch.from_numpy(feat)).numpy()
    assert got.shape == want.shape == (3, 4, 64)
    assert _rel(got, want) < REL
    px = rng.standard_normal((3, 3, 56, 56)).astype(np.float32)
    want = np.asarray(jvit.encode_images(jp, jnp.asarray(px)))
    got = vit.encode_images(vp, torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (3, 4, 64)
    assert _rel(got, want) < REL
    jax.clear_caches()
