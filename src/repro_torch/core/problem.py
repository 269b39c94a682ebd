"""Problem descriptions for the paper's CNN operator -- the port of
``repro/core/problem.py`` (pure Python, a copy the port keeps).

The paper's operator is

    Out[b, k, w, h] += In[b, c, sw*w + r, sh*h + s] * Ker[k, c, r, s]

with iteration space N_b x N_k x N_c x N_h x N_w x N_r x N_s and strides
(sw, sh).  Matrix multiplication is the degenerate case
N_r = N_s = N_h = N_w = 1, stride 1 -- every transformer matmul is expressed
through :meth:`ConvProblem.from_matmul` so the paper's synthesizer applies
uniformly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ConvProblem:
    """Shape of one CNN (or CNN-ized matmul) operator instance."""

    Nb: int  # batch
    Nk: int  # output features
    Nc: int  # input features (contraction)
    Nh: int  # output spatial height
    Nw: int  # output spatial width
    Nr: int = 1  # stencil height
    Ns: int = 1  # stencil width
    sh: int = 1  # stride (vertical)
    sw: int = 1  # stride (horizontal)
    bytes_per_elem: int = 2  # bf16 by default

    # ---------------------------------------------------------------- shapes
    @property
    def Nbhw(self) -> int:
        """Composite reuse-equivalent index (paper Sec. 2)."""
        return self.Nb * self.Nh * self.Nw

    @property
    def in_h(self) -> int:
        return self.sh * self.Nh + self.Nr - 1

    @property
    def in_w(self) -> int:
        return self.sw * self.Nw + self.Ns - 1

    def size_in(self) -> int:
        """Elements of In[b, c, h, w] (padded/valid view used by the paper)."""
        return self.Nb * self.Nc * self.in_h * self.in_w

    def size_ker(self) -> int:
        return self.Nk * self.Nc * self.Nr * self.Ns

    def size_out(self) -> int:
        return self.Nb * self.Nk * self.Nh * self.Nw

    def flops(self) -> int:
        """MACs * 2 for the forward operator."""
        return (2 * self.Nb * self.Nk * self.Nc * self.Nh * self.Nw
                * self.Nr * self.Ns)

    def arithmetic_intensity(self) -> float:
        moved = (self.size_in() + self.size_ker()
                 + self.size_out()) * self.bytes_per_elem
        return self.flops() / moved

    # ------------------------------------------------------------ factories
    @classmethod
    def from_matmul(cls, m: int, n: int, k: int, *,
                    bytes_per_elem: int = 2) -> "ConvProblem":
        """Out[m, n] = In[m, k] @ Ker[n, k]  ==  CNN with 1x1 kernel/image.

        ``m`` plays the role of the composite bhw index (batch*seq for a
        transformer layer), ``n`` the output features, ``k`` the contraction.
        """
        return cls(Nb=m, Nk=n, Nc=k, Nh=1, Nw=1, Nr=1, Ns=1, sh=1, sw=1,
                   bytes_per_elem=bytes_per_elem)

    @classmethod
    def from_conv_layer(cls, *, batch: int, cin: int, cout: int,
                        h: int, w: int,
                        kh: int, kw: int, stride: int = 1,
                        bytes_per_elem: int = 2) -> "ConvProblem":
        """Standard deep-learning conv layer (output spatial size h x w)."""
        return cls(Nb=batch, Nk=cout, Nc=cin, Nh=h, Nw=w, Nr=kh, Ns=kw,
                   sh=stride, sw=stride, bytes_per_elem=bytes_per_elem)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    # ------------------------------------------------------------- utilities
    @property
    def stencil_volume(self) -> int:
        return self.Nr * self.Ns

    @property
    def stride_volume(self) -> int:
        return self.sh * self.sw

    @property
    def K(self) -> float:
        """K = sqrt(sw*sh*Nr*Ns) from the paper's M_L correction."""
        return math.sqrt(self.stride_volume * self.stencil_volume)

    def iteration_points(self) -> int:
        return self.Nbhw * self.Nk * self.Nc * self.Nr * self.Ns


# Canonical layer tables used by benchmarks / tests -------------------------

def resnet50_layers(batch: int = 64) -> Dict[str, ConvProblem]:
    """Representative ResNet-50 conv layers (the paper's natural workload)."""
    specs = {
        # name: (cin, cout, out_h, out_w, k, stride)
        "conv1": (3, 64, 112, 112, 7, 2),
        "res2a_2b": (64, 64, 56, 56, 3, 1),
        "res3a_2b": (128, 128, 28, 28, 3, 1),
        "res4a_2b": (256, 256, 14, 14, 3, 1),
        "res5a_2b": (512, 512, 7, 7, 3, 1),
        "res2_1x1": (64, 256, 56, 56, 1, 1),
        "res5_1x1": (512, 2048, 7, 7, 1, 1),
    }
    return {
        name: ConvProblem.from_conv_layer(
            batch=batch, cin=cin, cout=cout, h=h, w=w, kh=k, kw=k, stride=s)
        for name, (cin, cout, h, w, k, s) in specs.items()
    }
