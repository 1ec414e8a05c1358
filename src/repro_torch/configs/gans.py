"""The six GAN workloads of the paper (Table I), as layer topologies.

Layer geometries follow the source papers (DCGAN-family generators:
stride-2 4×4 transposed convs halving channels while doubling spatial size;
3D-GAN: volumetric 4×4×4 stride-2; MAGAN: an autoencoder discriminator and a
generator mixing stride-1 and stride-2 transposed convs, which is why its
inserted-zero fraction — and hence its GANAX speedup — is the lowest, Fig. 1
/ Fig. 8).  Where a source paper leaves a dimension unspecified we follow
the DCGAN convention and note it here rather than in the code.

A copy of ``repro.configs.gans`` (data only): the port imports nothing
of the JAX package, and the parity tests hold the two tables equal field
by field.  They drive the port's executable GAN models (models/gan.py).
"""

from __future__ import annotations

from repro_torch.core.analytical import ConvLayer

__all__ = ["GAN_MODELS", "gan_layers"]


def _t(name, hw, k, s, p, cin, cout, dims=2):
    return ConvLayer(name=name, in_spatial=(hw,) * dims, kernel=(k,) * dims,
                     strides=(s,) * dims, paddings=(p,) * dims,
                     cin=cin, cout=cout, transposed=True)


def _c(name, hw, k, s, p, cin, cout, dims=2):
    # Plain (downsampling) conv: stride s on its input resolution.
    return ConvLayer(name=name, in_spatial=(hw,) * dims, kernel=(k,) * dims,
                     strides=(s,) * dims, paddings=(p,) * dims,
                     cin=cin, cout=cout, transposed=False)


# --------------------------------------------------------------------------
# DCGAN (Radford et al. 2015): 64×64 generator, 4 tconv / 5 conv.
# --------------------------------------------------------------------------
DCGAN_G = [
    _t("g1", 4, 4, 2, 1, 1024, 512),
    _t("g2", 8, 4, 2, 1, 512, 256),
    _t("g3", 16, 4, 2, 1, 256, 128),
    _t("g4", 32, 4, 2, 1, 128, 3),
]
DCGAN_D = [
    _c("d1", 64, 4, 2, 1, 3, 128),
    _c("d2", 32, 4, 2, 1, 128, 256),
    _c("d3", 16, 4, 2, 1, 256, 512),
    _c("d4", 8, 4, 2, 1, 512, 1024),
    _c("d5", 4, 4, 1, 0, 1024, 1),
]

# --------------------------------------------------------------------------
# 3D-GAN (Wu et al. 2016): 64³ voxel generator, 4 tconv3d / 5 conv3d.
# Stride-2 in 3-D → 87.5% inserted zeros, the paper's highest (Fig. 1).
# --------------------------------------------------------------------------
GAN3D_G = [
    _t("g1", 4, 4, 2, 1, 512, 256, dims=3),
    _t("g2", 8, 4, 2, 1, 256, 128, dims=3),
    _t("g3", 16, 4, 2, 1, 128, 64, dims=3),
    _t("g4", 32, 4, 2, 1, 64, 1, dims=3),
]
GAN3D_D = [
    _c("d1", 64, 4, 2, 1, 1, 64, dims=3),
    _c("d2", 32, 4, 2, 1, 64, 128, dims=3),
    _c("d3", 16, 4, 2, 1, 128, 256, dims=3),
    _c("d4", 8, 4, 2, 1, 256, 512, dims=3),
    _c("d5", 4, 4, 1, 0, 512, 1, dims=3),
]

# --------------------------------------------------------------------------
# ArtGAN (Tan et al. 2017): 5 tconv (4 upsampling + 1 stride-1 refinement).
# --------------------------------------------------------------------------
ARTGAN_G = [
    _t("g1", 4, 4, 2, 1, 1024, 512),
    _t("g2", 8, 4, 2, 1, 512, 256),
    _t("g3", 16, 4, 2, 1, 256, 128),
    _t("g4", 32, 4, 2, 1, 128, 64),
    _t("g5", 64, 5, 1, 2, 64, 3),
]
ARTGAN_D = [
    _c("d1", 64, 4, 2, 1, 3, 64),
    _c("d2", 32, 4, 2, 1, 64, 128),
    _c("d3", 16, 4, 2, 1, 128, 256),
    _c("d4", 8, 4, 2, 1, 256, 512),
    _c("d5", 4, 4, 2, 1, 512, 1024),
    _c("d6", 2, 2, 1, 0, 1024, 1),
]

# --------------------------------------------------------------------------
# DiscoGAN (Kim et al. 2017): encoder-decoder generator (5 conv + 5 tconv).
# --------------------------------------------------------------------------
DISCOGAN_G = [
    _c("e1", 64, 4, 2, 1, 3, 64),
    _c("e2", 32, 4, 2, 1, 64, 128),
    _c("e3", 16, 4, 2, 1, 128, 256),
    _c("e4", 8, 4, 2, 1, 256, 512),
    _c("e5", 4, 4, 2, 1, 512, 1024),
    _t("g1", 2, 4, 2, 1, 1024, 512),
    _t("g2", 4, 4, 2, 1, 512, 256),
    _t("g3", 8, 4, 2, 1, 256, 128),
    _t("g4", 16, 4, 2, 1, 128, 64),
    _t("g5", 32, 4, 2, 1, 64, 3),
]
DISCOGAN_D = [
    _c("d1", 64, 4, 2, 1, 3, 64),
    _c("d2", 32, 4, 2, 1, 64, 128),
    _c("d3", 16, 4, 2, 1, 128, 256),
    _c("d4", 8, 4, 2, 1, 256, 512),
    _c("d5", 4, 4, 1, 0, 512, 1),
]

# --------------------------------------------------------------------------
# GP-GAN (Wu et al. 2017): blending GAN, DCGAN-like decoder with wider
# channels (encoder-decoder; we model the generative tconv stack).
# --------------------------------------------------------------------------
GPGAN_G = [
    _t("g1", 4, 4, 2, 1, 2048, 1024),
    _t("g2", 8, 4, 2, 1, 1024, 512),
    _t("g3", 16, 4, 2, 1, 512, 256),
    _t("g4", 32, 4, 2, 1, 256, 3),
]
GPGAN_D = [
    _c("d1", 64, 4, 2, 1, 3, 64),
    _c("d2", 32, 4, 2, 1, 64, 128),
    _c("d3", 16, 4, 2, 1, 128, 256),
    _c("d4", 8, 4, 2, 1, 256, 512),
    _c("d5", 4, 4, 1, 0, 512, 1),
]

# --------------------------------------------------------------------------
# MAGAN (Wang et al. 2017): 6 tconv generator; the refinement layers are
# stride-1 (no inserted zeros), so the MAC-weighted zero fraction is the
# pool's lowest → smallest speedup (paper: 1.3×).  The discriminator is an
# autoencoder (6 conv + 6 tconv); per the paper's methodology only its conv
# layers count toward the discriminator totals.
# --------------------------------------------------------------------------
MAGAN_G = [
    _t("g1", 4, 4, 2, 1, 512, 256),
    _t("g2", 8, 5, 1, 2, 256, 256),
    _t("g3", 8, 4, 2, 1, 256, 128),
    _t("g4", 16, 5, 1, 2, 128, 128),
    _t("g5", 16, 5, 1, 2, 128, 64),
    _t("g6", 16, 5, 1, 2, 64, 3),
]
MAGAN_D = [
    _c("d1", 16, 4, 2, 1, 3, 64),
    _c("d2", 8, 4, 2, 1, 64, 128),
    _c("d3", 4, 4, 2, 1, 128, 256),
    _c("d4", 2, 2, 2, 0, 256, 512),
    _c("d5", 1, 1, 1, 0, 512, 256),
    _c("d6", 1, 1, 1, 0, 256, 128),
]

GAN_MODELS: dict[str, tuple[list[ConvLayer], list[ConvLayer]]] = {
    "3dgan": (GAN3D_G, GAN3D_D),
    "artgan": (ARTGAN_G, ARTGAN_D),
    "dcgan": (DCGAN_G, DCGAN_D),
    "discogan": (DISCOGAN_G, DISCOGAN_D),
    "gpgan": (GPGAN_G, GPGAN_D),
    "magan": (MAGAN_G, MAGAN_D),
}


def gan_layers(name: str) -> tuple[list[ConvLayer], list[ConvLayer]]:
    return GAN_MODELS[name]
