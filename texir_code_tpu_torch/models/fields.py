"""Neural fields of the field stages (the port of the JAX package's
`models/fields.py`, reference models/incidentNet.py + models/embedder.py):

  * ``positional_encoding`` / ``pe_dim`` — NeRF PE (embedder.py:6-53);
  * ``MatNetwork`` — PE → LeakyReLU(0.01) MLP with Kaiming-uniform weights,
    the NIrF irradiance field (incidentNet.py:103-142);
  * ``frequency_encoding`` — PE without the raw input (embedder.py:114-159);
  * ``IRNetwork`` — (point, direction) → RGB radiance, ReLU (:16-53);
  * ``PILNetwork`` — (point, direction, roughness) → prefiltered specular,
    LeakyReLU(0.01) (:202-239);
  * ``IRSGNetwork`` — point → 24 spherical Gaussians, ReLU (:55-101);
  * the baseline heads' networks: ``SineLayer`` / ``BRDFMLP`` /
    ``NeILFMLP`` — SIREN with skips (:421-627); ``EnvmapMaterialNetwork``
    — InvRender's latent-32 BRDF autoencoder (:268-327);
    ``HashGridEncoding`` / ``MLPTexture3D`` — nvdiffrec's hash-grid field
    (:331-416), the tiny-cuda-nn encoding in plain PyTorch.

Each is an `nn.Module`.  The field stages' networks keep their
`nn.Linear` layers in `self.layers` (hidden layers, then the output
layer), so `layers.i` is flax's `Dense_i`; the heads' networks name their
flax counterparts in `flax_names()`.  `convert.field_params_from_flax`
carries weights across.  Weights are drawn from the distributions flax
uses (Kaiming-uniform for MatNetwork and MLPTexture3D, flax's default
lecun-normal, a normal truncated at two deviations, for the others; the
SIREN bounds; zero output layers) and biases start at zero (NeILFMLP's
output at ln 1.5), so a run from scratch trains as the JAX one does.
All fields are fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF positional encoding with log-sampled bands 2^0..2^(m-1), in the
    reference embedder's order (models/embedder.py:27-31):
    [x, sin(x·2^0), cos(x·2^0), sin(x·2^1), ...]."""
    outs = [x] if include_input else []
    for i in range(num_freqs):
        freq = 2.0 ** i
        outs.append(torch.sin(x * freq))
        outs.append(torch.cos(x * freq))
    return torch.cat(outs, dim=-1)


def pe_dim(in_dim: int, num_freqs: int, include_input: bool = True) -> int:
    return in_dim * (2 * num_freqs + (1 if include_input else 0))


def frequency_encoding(x: torch.Tensor,
                       n_frequencies: int = 6) -> torch.Tensor:
    """tcnn 'Frequency' encoding: sin/cos at 2^k without the raw input."""
    return positional_encoding(x, n_frequencies, include_input=False)


def _encode(x: torch.Tensor, multires: int) -> torch.Tensor:
    return positional_encoding(x, multires) if multires > 0 else x


def _in_dim(dim: int, multires: int) -> int:
    return pe_dim(dim, multires) if multires > 0 else dim


@torch.no_grad()
def _init_linear(layer: nn.Linear, init: str,
                 generator: Optional[torch.Generator] = None) -> None:
    """Draw a layer's weights as flax does ('kaiming_uniform': U(±√(6/in));
    'lecun_normal': a normal of deviation √(1/in) truncated at two
    deviations; 'zeros'); biases start at zero."""
    fan_in = layer.weight.shape[1]
    if init == "kaiming_uniform":
        bound = math.sqrt(6.0 / fan_in)
        layer.weight.uniform_(-bound, bound, generator=generator)
    elif init == "lecun_normal":
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    elif init == "zeros":
        layer.weight.zero_()
    else:
        raise ValueError(f"unknown init {init!r}")
    if layer.bias is not None:
        layer.bias.zero_()


class _MLP(nn.Module):
    """Linear layers of widths `dims` then `out_dim`, an activation after
    every hidden layer, weights from `init` ('kaiming_uniform' or
    'lecun_normal'), zero biases."""

    def __init__(self, in_dim: int, dims: Sequence[int], out_dim: int,
                 negative_slope: Optional[float], init: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_dim] + list(dims) + [out_dim]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.negative_slope = negative_slope
        for layer in self.layers:
            _init_linear(layer, init, generator)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = layer(x)
            x = (torch.relu(x) if self.negative_slope is None
                 else nn.functional.leaky_relu(x, self.negative_slope))
        return self.layers[-1](x)


class MatNetwork(_MLP):
    """PE → LeakyReLU(0.01) MLP (reference incidentNet.py:103-142): the
    NIrF irradiance field — a 3D point in, `p_out_dim` channels out in
    hdr_scale (log) domain."""

    def __init__(self, points_multires: int = 10,
                 dims: Sequence[int] = (512, 512, 512, 512),
                 p_out_dim: int = 3, p_input_dim: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_in_dim(p_input_dim, points_multires), dims,
                         p_out_dim, 0.01, "kaiming_uniform", generator)
        self.points_multires = points_multires

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        return self.mlp(_encode(points, self.points_multires))


class IRNetwork(_MLP):
    """(point, direction) → RGB incident radiance, ReLU (reference
    incidentNet.py:16-53)."""

    def __init__(self, points_multires: int = 10, dirs_multires: int = 4,
                 dims: Sequence[int] = (128, 128, 128, 128),
                 generator: Optional[torch.Generator] = None):
        super().__init__(_in_dim(3, points_multires)
                         + _in_dim(3, dirs_multires), dims, 3, None,
                         "lecun_normal", generator)
        self.points_multires = points_multires
        self.dirs_multires = dirs_multires

    def forward(self, points: torch.Tensor,
                dirs: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([_encode(points, self.points_multires),
                                   _encode(dirs, self.dirs_multires)], dim=-1))


class PILNetwork(_MLP):
    """(point, direction, roughness) → prefiltered specular radiance,
    LeakyReLU(0.01) (reference incidentNet.py:202-239)."""

    def __init__(self, points_multires: int = 10, dirs_multires: int = 4,
                 dims: Sequence[int] = (128, 128, 128, 128),
                 p_out_dim: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_in_dim(3, points_multires)
                         + _in_dim(3, dirs_multires) + 1, dims, p_out_dim,
                         0.01, "lecun_normal", generator)
        self.points_multires = points_multires
        self.dirs_multires = dirs_multires

    def forward(self, points: torch.Tensor, dirs: torch.Tensor,
                roughness: torch.Tensor) -> torch.Tensor:
        return self.mlp(torch.cat([_encode(points, self.points_multires),
                                   _encode(dirs, self.dirs_multires),
                                   roughness], dim=-1))


class IRSGNetwork(_MLP):
    """point → `num_lgt_sgs` spherical Gaussians, ReLU (reference
    incidentNet.py:55-101; present in the reference, unused by its
    runners).  Each lobe is [direction (3), λ, μ (3)]: the direction from
    two sigmoid angles, λ = 30·sigmoid + 0.1, μ = relu."""

    def __init__(self, points_multires: int = 10,
                 dims: Sequence[int] = (128, 128, 128, 128),
                 num_lgt_sgs: int = 24,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_in_dim(3, points_multires), dims, num_lgt_sgs * 6,
                         None, "lecun_normal", generator)
        self.points_multires = points_multires
        self.num_lgt_sgs = num_lgt_sgs

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        out = self.mlp(_encode(points, self.points_multires))
        out = out.reshape(points.shape[:-1] + (self.num_lgt_sgs, 6))
        lobes = torch.sigmoid(out[..., :2])
        theta = lobes[..., 0:1] * 2 * math.pi
        phi = lobes[..., 1:2] * 2 * math.pi
        lobe_dir = torch.cat([torch.cos(theta) * torch.sin(phi),
                              torch.sin(theta) * torch.sin(phi),
                              torch.cos(phi)], dim=-1)
        lam = torch.sigmoid(out[..., 2:3]) * 30.0 + 0.1
        mu = torch.relu(out[..., 3:6])
        return torch.cat([lobe_dir, lam, mu], dim=-1)


# ---------------------------------------------------------------------------
# the baseline heads' networks
# ---------------------------------------------------------------------------


class SineLayer(nn.Module):
    """sin(Wx + b) (reference incidentNet.py:421-455).  ω enters only the
    first layer's init, U(±ω/in); the others draw U(±√(3/in)); zero bias."""

    def __init__(self, in_dim: int, out_dim: int, is_first: bool = False,
                 omega: float = 30.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)
        bound = omega / in_dim if is_first else math.sqrt(3.0 / in_dim)
        with torch.no_grad():
            self.linear.weight.uniform_(-bound, bound, generator=generator)
            self.linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.linear(x))


class _Siren(nn.Module):
    """Sine layers of widths `dims`, then a zero-initialised linear output
    layer.  At each layer index in `skip` the encoded input is
    concatenated, at each in `insert` the extra input (NeILF's position);
    the layer before takes their widths off its own, so every hidden layer
    keeps its width (reference incidentNet.py:457-534, :537-627)."""

    def __init__(self, d0: int, dims: Sequence[int], out_dim: int,
                 skip: Sequence[int], insert: Sequence[int], first: bool,
                 last_bias: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip, self.insert = tuple(skip), tuple(insert)
        widths = [d0] + list(dims) + [out_dim]
        layers, width = [], d0
        for l in range(len(widths) - 1):
            out = widths[l + 1]
            out -= d0 if l + 1 in self.skip else 0
            out -= 3 if l + 1 in self.insert else 0
            width += d0 if l in self.skip else 0
            width += 3 if l in self.insert else 0
            if l < len(widths) - 2:
                layers.append(SineLayer(width, out, is_first=first and l == 0,
                                        generator=generator))
            else:
                last = nn.Linear(width, out)
                _init_linear(last, "zeros")
                with torch.no_grad():
                    last.bias.fill_(last_bias)
                layers.append(last)
            width = out
        self.layers = nn.ModuleList(layers)

    def siren(self, x0: torch.Tensor,
              extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x0
        for l, layer in enumerate(self.layers):
            if l in self.skip:
                x = torch.cat([x, x0], dim=-1)
            if l in self.insert:
                x = torch.cat([x, extra], dim=-1)
            x = layer(x)
        return x

    def flax_names(self) -> Dict[str, Tuple[str, ...]]:
        """State-dict prefix → flax params path of each Dense layer."""
        n = len(self.layers)
        names = {f"layers.{i}.linear": (f"SineLayer_{i}", "Dense_0")
                 for i in range(n - 1)}
        names[f"layers.{n - 1}"] = ("Dense_0",)
        return names


class BRDFMLP(_Siren):
    """NeILF's spatial BRDF SIREN: point → (albedo 3, roughness 1) in
    [0, 1] through tanh/2 + 0.5 (reference incidentNet.py:457-534).  With
    the default PE every sine layer takes the hidden init."""

    def __init__(self, in_dims: int = 3, out_dims: int = 4,
                 dims: Sequence[int] = (512,) * 8,
                 skip_connection: Sequence[int] = (4,),
                 multires_view: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_in_dim(in_dims, multires_view), dims, out_dims,
                         skip_connection, (), multires_view == 0, 0.0,
                         generator)
        self.multires_view = multires_view

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x = self.siren(_encode(points, self.multires_view))
        return torch.tanh(x) / 2.0 + 0.5


class NeILFMLP(_Siren):
    """NeILF's incident-light SIREN: (position, direction) packed as
    [..., 6] → radiance in hdr_scale domain; the encoded direction skips
    in and the position is inserted at layer 4; the output bias starts at
    ln 1.5 (reference incidentNet.py:537-627)."""

    def __init__(self, out_dims: int = 3, dims: Sequence[int] = (128,) * 8,
                 skip_connection: Sequence[int] = (4,),
                 position_insertion: Sequence[int] = (4,),
                 multires_view: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_in_dim(3, multires_view), dims, out_dims,
                         skip_connection, position_insertion,
                         multires_view == 0, math.log(1.5), generator)
        self.multires_view = multires_view

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        return self.siren(_encode(points[..., 3:6], self.multires_view),
                          points[..., 0:3])


class EnvmapMaterialNetwork(nn.Module):
    """InvRender's BRDF autoencoder (reference incidentNet.py:268-327):
    PE(point) → encoder → sigmoid latent (32) → decoder → sigmoid BRDF,
    LeakyReLU(0.2) between layers, flax's lecun-normal weights.  Given a
    standard normal `noise` [N, latent], it also decodes the latent
    jittered by 0.01 · noise for the smoothness loss."""

    def __init__(self, multires: int = 10,
                 brdf_encoder_dims: Sequence[int] = (512, 512, 512, 512),
                 brdf_decoder_dims: Sequence[int] = (128, 128),
                 latent_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.multires = multires
        enc = [_in_dim(3, multires)] + list(brdf_encoder_dims) + [latent_dim]
        dec = [latent_dim] + list(brdf_decoder_dims) + [4]
        self.encoder_layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(enc[:-1], enc[1:]))
        self.decoder_layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dec[:-1], dec[1:]))
        for layer in (*self.encoder_layers, *self.decoder_layers):
            _init_linear(layer, "lecun_normal", generator)

    @staticmethod
    def _stack(layers, x):
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = nn.functional.leaky_relu(x, 0.2)
        return x

    def encode(self, points: torch.Tensor) -> torch.Tensor:
        """The latent before its sigmoid."""
        return self._stack(self.encoder_layers, _encode(points, self.multires))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._stack(self.decoder_layers, latent))

    def forward(self, points: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        pre = self.encode(points)
        latent = torch.sigmoid(pre)
        brdf = self.decode(latent)
        out = {
            "roughness": brdf[..., 3:] * 0.9 + 0.09,
            "diffuse_albedo": brdf[..., :3],
            "latent": latent,
            "latent_pre_sigmoid": pre,
        }
        if noise is not None:
            brdf_j = self.decode(latent + noise * 0.01)
            out["random_xi_roughness"] = brdf_j[..., 3:] * 0.9 + 0.09
            out["random_xi_diffuse_albedo"] = brdf_j[..., :3]
        return out

    def flax_names(self) -> Dict[str, Tuple[str, ...]]:
        return {
            **{f"encoder_layers.{i}": (f"encoder_layers_{i}",)
               for i in range(len(self.encoder_layers))},
            **{f"decoder_layers.{i}": (f"decoder_layers_{i}",)
               for i in range(len(self.decoder_layers))},
        }


# the spatial hash's primes (tiny-cuda-nn's), and the corners of a cell
_HASH_PRIMES = (1, 2654435761, 805459861)
_CORNERS = tuple(tuple((c >> k) & 1 for k in range(3)) for c in range(8))


class HashGridEncoding(nn.Module):
    """Multiresolution hash-grid encoding (tcnn 'HashGrid', reference
    incidentNet.py:378-389): 16 levels of 2 features, a 2^19-entry table
    per level, resolutions floor(16 · b^l) from 16 to 4095.  A level whose
    (res + 1)³ corners fit in the table indexes them densely (levels
    0-4), the others hash them (x·1 ^ y·2654435761 ^ z·805459861, low 19
    bits: each product is formed in int64, and 2^19 divides 2^32, so the
    uint32 wrap changes no index).  Each point blends the 8 corners of its
    cell trilinearly; every level's corners are gathered from the flat
    table in one indexing, whose backward is one scatter-add."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 16,
                 desired_resolution: int = 4096,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.table_size = 2 ** log2_hashmap_size
        self.table = nn.Parameter(torch.empty(
            num_levels, self.table_size, features_per_level))
        with torch.no_grad():
            self.table.uniform_(-1e-4, 1e-4, generator=generator)
        growth = math.exp(math.log(desired_resolution / base_resolution)
                          / (num_levels - 1))
        self.resolutions = [int(math.floor(base_resolution * growth ** level))
                            for level in range(num_levels)]

    @property
    def out_dim(self) -> int:
        return self.table.shape[0] * self.table.shape[2]

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        """x01 [..., 3] in [0, 1] → [..., levels · features]."""
        lead = x01.shape[:-1]
        x = x01.reshape(-1, 3)
        offs = torch.tensor(_CORNERS, device=x.device)              # [8, 3]
        idx, wts = [], []
        for level, res in enumerate(self.resolutions):
            pos = x * res
            cell = torch.floor(pos)
            frac = (pos - cell)[:, None, :]
            c = torch.clamp(cell.to(torch.int64)[:, None, :] + offs, 0, res)
            if (res + 1) ** 3 <= self.table_size:
                i = (c[..., 0] * (res + 1) + c[..., 1]) * (res + 1) + c[..., 2]
            else:
                i = ((c[..., 0] * _HASH_PRIMES[0])
                     ^ (c[..., 1] * _HASH_PRIMES[1])
                     ^ (c[..., 2] * _HASH_PRIMES[2])) & (self.table_size - 1)
            w = torch.where(offs == 1, frac, 1.0 - frac)            # [N, 8, 3]
            idx.append(i + level * self.table_size)
            wts.append(w[..., 0] * w[..., 1] * w[..., 2])
        flat = self.table.reshape(-1, self.table.shape[2])
        feats = (flat[torch.stack(idx, 1)]
                 * torch.stack(wts, 1)[..., None]).sum(2)           # [N, L, F]
        return feats.reshape(*lead, self.out_dim)


class MLPTexture3D(nn.Module):
    """nvdiffrec's hash-grid material field (reference incidentNet.py:
    360-416): points normalised into the mesh's AABB, hash-encoded, two
    bias-free ReLU layers of 32 (kaiming-uniform), a sigmoid remapped per
    channel to [min, max] (albedo [0, 1]³, roughness [0.01, 1])."""

    def __init__(self, aabb, channels: int = 4, internal_dims: int = 32,
                 hidden: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.register_buffer("aabb", torch.as_tensor(
            aabb, dtype=torch.float32).reshape(2, 3), persistent=False)
        self.register_buffer("lo", torch.tensor(
            [0.0, 0.0, 0.0, 0.01][:channels]), persistent=False)
        self.encoding = HashGridEncoding(generator=generator)
        widths = ([self.encoding.out_dim] + [internal_dims] * hidden
                  + [channels])
        self.layers = nn.ModuleList(nn.Linear(a, b, bias=False)
                                    for a, b in zip(widths[:-1], widths[1:]))
        for layer in self.layers:
            _init_linear(layer, "kaiming_uniform", generator)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x01 = torch.clamp((points - self.aabb[0])
                          / (self.aabb[1] - self.aabb[0]), 0.0, 1.0)
        x = self.encoding(x01)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        x = self.layers[-1](x)
        return torch.sigmoid(x) * (1.0 - self.lo) + self.lo

    def flax_names(self) -> Dict[str, Tuple[str, ...]]:
        names = {f"layers.{i}": (f"Dense_{i}",)
                 for i in range(len(self.layers))}
        names["encoding.table"] = ("HashGridEncoding_0", "table")
        return names
