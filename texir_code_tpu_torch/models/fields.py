"""Neural fields of the field stages (the port of the JAX package's
`models/fields.py`, reference models/incidentNet.py + models/embedder.py):

  * ``positional_encoding`` / ``pe_dim`` — NeRF PE (embedder.py:6-53);
  * ``MatNetwork`` — PE → LeakyReLU(0.01) MLP with Kaiming-uniform weights,
    the NIrF irradiance field (incidentNet.py:103-142);
  * ``frequency_encoding`` — PE without the raw input (embedder.py:114-159);
  * ``IRNetwork`` — (point, direction) → RGB radiance, ReLU (:16-53);
  * ``PILNetwork`` — (point, direction, roughness) → prefiltered specular,
    LeakyReLU(0.01) (:202-239).

Each is an `nn.Module` of `nn.Linear` layers in `self.layers` (hidden
layers, then the output layer), so `layers.i` is flax's `Dense_i`
(`convert.field_params_from_flax` carries weights across).  Weights are
drawn from the distributions flax uses — Kaiming-uniform for MatNetwork,
flax's default lecun-normal (a normal truncated at two deviations) for the
others — and biases start at zero, so a run from scratch trains as the JAX
one does.  All fields are fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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
        with torch.no_grad():
            for layer in self.layers:
                fan_in = layer.weight.shape[1]
                if init == "kaiming_uniform":
                    bound = math.sqrt(6.0 / fan_in)
                    layer.weight.uniform_(-bound, bound, generator=generator)
                else:
                    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                          b=2 * std, generator=generator)
                layer.bias.zero_()

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
