"""InternVL-style ViT vision tower and multimodal projector: the JAX
package's models/vit.py as nn.Modules with a Python loop over the
layers.

Patch-conv embedding (as a matmul over patchify's rows) + cls token +
absolute position embeddings, pre-LN blocks with layer scale
(lambda_1/lambda_2), then pixel-shuffle downsampling and a LayerNorm-MLP
projector into the language model's embedding space.

Numerics follow the JAX package's dtypes, product by product:
  - the patch embedding, the residual stream, the norms and the
    projector are f32 (the f32 products run without TF32);
  - each layer's matmul weights are stored in bf16 once (JAX casts its
    f32 weights to bf16 at every product: the same values), their
    inputs rounded to bf16 and their outputs bf16, then the f32 bias
    added in f32 (so q/k/v are f32 when the tower has q/k/v biases, as
    InternViT has, and bf16 without);
  - attention is explicit matmuls: f32 scores over the q/k values,
    softmax in f32, the probabilities rounded to bf16, P.V accumulated in
    f32 (JAX's einsums with preferred_element_type=f32). No SDPA: it
    rounds differently;
  - GELU is exact (erf).
The tower has no Pallas kernel in the JAX package; its products are
plain matmuls here too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device

# the per-layer tensors (q|k|v concatenated), in VisionParams' layer order
LAYER_FIELDS = ("qkv_w", "qkv_b", "proj_w", "proj_b", "fc1_w", "fc1_b",
                "fc2_w", "fc2_b", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
                "lambda1", "lambda2")
# the matmul weights kept in bf16
BF16_FIELDS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
TOP_FIELDS = ("patch_w", "patch_b", "cls_token", "pos_embed", "proj_ln_w",
              "proj_ln_b", "proj_fc1_w", "proj_fc1_b", "proj_fc2_w",
              "proj_fc2_b")


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm in f32 (JAX's _layer_norm: mean, mean of squares)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * w + b


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: torch.Tensor | None) -> torch.Tensor:
    """x rounded to w's dtype @ w (output in w's dtype), + the f32 bias in
    f32 (JAX's bf16 product + f32 bias promotes to f32)."""
    y = x.to(w.dtype) @ w
    return y if b is None else y.float() + b


class ViTLayer(nn.Module):
    """One pre-LN block: attention and MLP, each scaled by its lambda."""

    def __init__(self, **tensors):
        super().__init__()
        for name in LAYER_FIELDS:
            self.register_buffer(name, tensors.get(name))

    def forward(self, x: torch.Tensor, n_heads: int,
                eps: float) -> torch.Tensor:
        """x f32 [B, T, D] -> f32 [B, T, D]."""
        B, T, D = x.shape
        hd = D // n_heads
        h = _layer_norm(x, self.ln1_w, self.ln1_b, eps)
        qkv = _linear(h, self.qkv_w, self.qkv_b)

        def heads(t):
            return t.reshape(B, T, n_heads, hd).transpose(1, 2)

        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        att = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        att = torch.softmax(att, dim=-1).to(torch.bfloat16)
        out = (att.float() @ v.float()).transpose(1, 2).reshape(B, T, D)
        out = _linear(out, self.proj_w, self.proj_b)
        if self.lambda1 is not None:
            out = out * self.lambda1
        x = x + out.float()
        h2 = _layer_norm(x, self.ln2_w, self.ln2_b, eps)
        m = F.gelu(_linear(h2, self.fc1_w, self.fc1_b).float(),
                   approximate="none")
        m = _linear(m, self.fc2_w, self.fc2_b)
        if self.lambda2 is not None:
            m = m * self.lambda2
        return x + m.float()


class VisionParams(nn.Module):
    """The vision tower (patch embedding, cls token, position embeddings,
    layers) and the projector (LayerNorm, fc1, GELU, fc2)."""

    def __init__(self, layers: list[ViTLayer], patch_size: int, n_heads: int,
                 eps: float, downsample: float, **tensors):
        super().__init__()
        for name in TOP_FIELDS:
            self.register_buffer(name, tensors[name])
        self.layers = nn.ModuleList(layers)
        self.patch_size = patch_size
        self.n_heads = n_heads
        self.eps = eps
        self.downsample = downsample

    @property
    def dim(self) -> int:
        return self.patch_w.shape[1]


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, H, W] -> [B, (H/p)*(W/p), 3*p*p], each row a patch in the
    stride-p conv's (C, p, p) order."""
    B, C, H, W = pixel_values.shape
    x = pixel_values.reshape(B, C, H // patch, patch, W // patch, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, h, w, C, p, p]
    return x.reshape(B, (H // patch) * (W // patch), C * patch * patch)


@torch.no_grad()
def vision_encode(params: VisionParams,
                  pixel_values: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> patch features f32 [B, N, D] (the cls row
    dropped)."""
    patches = patchify(pixel_values.float(), params.patch_size)
    x = patches @ params.patch_w + params.patch_b  # [B, N, D]
    B, N, D = x.shape
    x = torch.cat([params.cls_token.expand(B, 1, D), x], dim=1)
    x = x + params.pos_embed[:, :N + 1]
    for layer in params.layers:
        x = layer(x, params.n_heads, params.eps)
    return x[:, 1:]


def pixel_shuffle(feat: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """[B, h, w, C] -> [B, h*s, w*s, C/s^2] (InternVL's ordering)."""
    B, Wd, Ht, C = feat.shape
    feat = feat.reshape(B, Wd, int(Ht * scale), int(C / scale))
    feat = feat.permute(0, 2, 1, 3)
    feat = feat.reshape(B, int(Ht * scale), int(Wd * scale),
                        int(C / (scale * scale)))
    return feat.permute(0, 2, 1, 3)


@torch.no_grad()
def project_image_features(params: VisionParams,
                           feat: torch.Tensor) -> torch.Tensor:
    """Patch features [B, N, D] -> f32 LLM embeddings [B, N*ds^2,
    text_dim]."""
    B, N, D = feat.shape
    side = int(math.isqrt(N))
    f = pixel_shuffle(feat.reshape(B, side, side, D), params.downsample)
    f = f.reshape(B, -1, f.shape[-1])
    h = _layer_norm(f, params.proj_ln_w, params.proj_ln_b, 1e-5)
    h = F.gelu(h @ params.proj_fc1_w + params.proj_fc1_b, approximate="none")
    return h @ params.proj_fc2_w + params.proj_fc2_b


def encode_images(params: VisionParams,
                  pixel_values: torch.Tensor) -> torch.Tensor:
    """Pixels -> projected LLM-space embeddings f32 [B, tokens, text_dim]."""
    return project_image_features(params, vision_encode(params, pixel_values))


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _to(a, device: torch.device, dtype=torch.float32) -> torch.Tensor | None:
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype)


def make_vision_params(top: dict, layers: list[dict], patch_size: int,
                       n_heads: int, eps: float, downsample: float,
                       device: torch.device) -> VisionParams:
    """VisionParams on `device` from f32 arrays or tensors (layer matmul
    weights [in, out], stored bf16; absent biases and lambdas None)."""
    vl = [ViTLayer(**{name: _to(lw.get(name), device,
                                torch.bfloat16 if name in BF16_FIELDS
                                else torch.float32)
                      for name in LAYER_FIELDS}) for lw in layers]
    return VisionParams(vl, patch_size, n_heads, eps, downsample,
                        **{name: _to(top[name], device)
                           for name in TOP_FIELDS})


def vision_params_from_hf(sd: dict[str, np.ndarray], n_layers: int,
                          n_heads: int, patch_size: int = 14,
                          eps: float = 1e-6, downsample: float = 0.5,
                          device: str | torch.device | None = None
                          ) -> VisionParams:
    """From an HF InternVL state dict as numpy (model.vision_tower.* and
    model.multi_modal_projector.*), onto `device` (default cuda)."""
    dev = resolve_device(device)

    def g(name):
        return np.asarray(sd[name], np.float32)

    def opt(name):
        return g(name) if name in sd else None

    pre = "model.vision_tower."
    conv = g(pre + "embeddings.patch_embeddings.projection.weight")
    D = conv.shape[0]
    layers = []
    for i in range(n_layers):
        lp = pre + f"encoder.layer.{i}."
        qkv_b = None
        if lp + "attention.q_proj.bias" in sd:
            qkv_b = np.concatenate([g(lp + f"attention.{n}_proj.bias")
                                    for n in "qkv"])
        layers.append(dict(
            qkv_w=np.concatenate([g(lp + f"attention.{n}_proj.weight").T
                                  for n in "qkv"], axis=1),
            qkv_b=qkv_b,
            proj_w=g(lp + "attention.projection_layer.weight").T,
            proj_b=g(lp + "attention.projection_layer.bias"),
            fc1_w=g(lp + "mlp.fc1.weight").T, fc1_b=g(lp + "mlp.fc1.bias"),
            fc2_w=g(lp + "mlp.fc2.weight").T, fc2_b=g(lp + "mlp.fc2.bias"),
            ln1_w=g(lp + "layernorm_before.weight"),
            ln1_b=g(lp + "layernorm_before.bias"),
            ln2_w=g(lp + "layernorm_after.weight"),
            ln2_b=g(lp + "layernorm_after.bias"),
            lambda1=opt(lp + "lambda_1"), lambda2=opt(lp + "lambda_2")))
    pp = "model.multi_modal_projector."
    top = dict(
        # conv [D, 3, p, p] -> [3*p*p, D] in patchify's (C, p, p) order
        patch_w=conv.reshape(D, -1).T,
        patch_b=g(pre + "embeddings.patch_embeddings.projection.bias"),
        cls_token=g(pre + "embeddings.cls_token"),
        pos_embed=g(pre + "embeddings.position_embeddings"),
        proj_ln_w=g(pp + "layer_norm.weight"),
        proj_ln_b=g(pp + "layer_norm.bias"),
        proj_fc1_w=g(pp + "linear_1.weight").T,
        proj_fc1_b=g(pp + "linear_1.bias"),
        proj_fc2_w=g(pp + "linear_2.weight").T,
        proj_fc2_b=g(pp + "linear_2.bias"))
    return make_vision_params(top, layers, patch_size, n_heads, eps,
                              downsample, dev)


def vision_params_from_numpy(tree: dict,
                             device: str | torch.device | None = None
                             ) -> VisionParams:
    """The JAX package's VisionParams as a dict of numpy arrays -> the
    port's, on `device` (default cuda).

    tree: the VisionParams fields (patch_w, ..., proj_fc2_b as arrays;
    patch_size, n_heads, eps, downsample) with "layers" a dict of the
    ViTLayer fields stacked on a leading [L] axis (None where absent)."""
    dev = resolve_device(device)
    st = tree["layers"]
    n = len(st["qkv_w"])
    layers = [{name: None if st.get(name) is None else st[name][i]
               for name in LAYER_FIELDS} for i in range(n)]
    return make_vision_params(tree, layers, int(tree["patch_size"]),
                              int(tree["n_heads"]), float(tree["eps"]),
                              float(tree["downsample"]), dev)
