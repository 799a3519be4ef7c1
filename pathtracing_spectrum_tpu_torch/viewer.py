"""Framebuffer readback viewer (port of ``pathtracing_spectrum_tpu/viewer.py``).

The reference displays the running mean as a single-channel grayscale image:
each frame it converts ``spectrumResult[pixel][channel] * 255`` into an RGB8
texture (main.cpp:3437-3453). Here that is host-side readback: grayscale
conversion, PNG export and a terminal ASCII preview, values clamped to
[0, 255]. For visible-range scenes, :func:`spectral_to_srgb` (host, float64)
and :func:`spectral_to_srgb_device` (torch, float32, on the accumulator's
device) map the spectrum through the CIE 1931 observer to sRGB.

Images are written by ``utils/image.py::write_image`` in the format their
extension names (the JAX package saves through PIL, which the port does
not import); the ``*_ch{k}.png`` names built here are PNG.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .utils.image import write_image


def to_grayscale(image: np.ndarray, channel: int,
                 scale: float = 255.0) -> np.ndarray:
    """[H, W, nw] spectral image -> uint8 [H, W] for one wave channel."""
    img = np.asarray(image)
    if img.ndim != 3 or not (0 <= channel < img.shape[2]):
        return np.zeros(img.shape[:2], np.uint8)
    chan = np.nan_to_num(img[:, :, channel], nan=0.0)
    return np.clip(chan * scale, 0.0, 255.0).astype(np.uint8)


def normalized_grayscale(image: np.ndarray, channel: int) -> np.ndarray:
    """Auto-exposure variant: channel max -> white (useful for thermal
    radiance values far from [0,1])."""
    img = np.asarray(image)
    chan = np.nan_to_num(img[:, :, channel], nan=0.0)
    mx = chan.max()
    if mx <= 0:
        return np.zeros(chan.shape, np.uint8)
    return np.clip(chan / mx * 255.0, 0.0, 255.0).astype(np.uint8)


def save_png(image: np.ndarray, channel: int, path: str,
             normalize: bool = True) -> None:
    write_image(path, normalized_grayscale(image, channel) if normalize
                else to_grayscale(image, channel))


def save_all_channels_png(image: np.ndarray, path_prefix: str,
                          normalize: bool = True) -> list:
    paths = []
    for k in range(np.asarray(image).shape[2]):
        p = f"{path_prefix}_ch{k}.png"
        save_png(image, k, p, normalize=normalize)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# CIE XYZ -> sRGB for visible-range spectral renders. Scenes author
# wavenumbers in 1/cm: samples whose wavelength 1e7/v lies in the visible
# band contribute through the CIE 1931 2-degree observer; pure-thermal-IR
# scenes legitimately map to black.
# ---------------------------------------------------------------------------

def _cie_gauss(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_bar(lambda_nm: np.ndarray) -> np.ndarray:
    """CIE 1931 2-deg color matching functions, [.., 3] (x̄, ȳ, z̄): the
    multi-lobe Gaussian fit of Wyman, Sloan & Shirley, JCGT 2013."""
    lam = np.asarray(lambda_nm, np.float64)
    x = (1.056 * _cie_gauss(lam, 599.8, 37.9, 31.0)
         + 0.362 * _cie_gauss(lam, 442.0, 16.0, 26.7)
         - 0.065 * _cie_gauss(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _cie_gauss(lam, 568.8, 46.9, 40.5)
         + 0.286 * _cie_gauss(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _cie_gauss(lam, 437.0, 11.8, 36.0)
         + 0.681 * _cie_gauss(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


_XYZ_TO_SRGB = np.array([[3.2406, -1.5372, -0.4986],
                         [-0.9689, 1.8758, 0.0415],
                         [0.0557, -0.2040, 1.0570]])

AUTO_EXPOSE_PERCENTILE = 99.5


def _cmf(wavenumbers) -> np.ndarray:
    """[nw, 3] float64 CMF weights of the scene's wavenumbers (1/cm)."""
    lam_nm = 1e7 / np.maximum(np.asarray(wavenumbers, np.float64), 1e-9)
    return cie_xyz_bar(lam_nm)


def spectral_to_srgb(image: np.ndarray, wavenumbers,
                     exposure: float = 0.0,
                     auto_expose: bool = True) -> np.ndarray:
    """[H, W, nw] spectral radiance + wavenumbers (1/cm) -> uint8 sRGB.

    XYZ is the CMF-weighted sum over the scene's spectral samples, then
    the D65 sRGB matrix + gamma. ``auto_expose`` scales the 99.5th
    percentile of Y to white; ``exposure`` adds stops on top.
    """
    img = np.nan_to_num(np.asarray(image, np.float64), nan=0.0)
    xyz = img @ _cmf(wavenumbers)                     # [H, W, 3]
    if auto_expose:
        ref = np.percentile(xyz[:, :, 1], AUTO_EXPOSE_PERCENTILE)
        if ref > 0:
            xyz = xyz / ref
    xyz = xyz * (2.0 ** exposure)
    rgb = xyz @ _XYZ_TO_SRGB.T
    rgb = np.clip(rgb, 0.0, 1.0)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                    1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return np.clip(srgb * 255.0, 0.0, 255.0).astype(np.uint8)


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of ``x`` as numpy's default
    ``linear`` method gives it, as a 0-d tensor of ``x``'s dtype on its
    device. One full ``sort``, so any size works (``torch.quantile``
    refuses inputs above 2**24 elements; two ``kthvalue`` selections took
    97 ms at 4K on an H100, the sort 0.56 ms: ``tools/srgb_epilogue.py``)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        raise ValueError("percentile of an empty tensor")
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    t = pos - lo
    ordered = flat.sort().values
    a, b = ordered[lo].double(), ordered[hi].double()
    diff = b - a
    # numpy's _lerp, in float64 as numpy does it: from the nearer end, so
    # t = 0 and t = 1 are exact
    v = b - diff * (1.0 - t) if t >= 0.5 else a + diff * t
    return v.to(x.dtype)


def spectral_to_srgb_device(image: torch.Tensor, wavenumbers,
                            exposure: float = 0.0,
                            auto_expose: bool = True) -> torch.Tensor:
    """The sRGB epilogue on the image's device: [..., nw] spectral ->
    uint8 [..., 3] tensor on the same device.

    The pipeline of :func:`spectral_to_srgb` (CMF weighting, 99.5th
    percentile auto-exposure, D65 sRGB matrix, gamma) in float32, so a
    viewer or ``--png-srgb`` reads back 3 uint8 channels instead of the
    float32 spectral image. Within 1 uint8 step of the host path. The
    products are IEEE float32: torch leaves TF32 off for matmuls unless a
    caller turns it on, and the port never does.
    """
    img = torch.nan_to_num(image.to(torch.float32), nan=0.0)
    f32 = dict(dtype=torch.float32, device=img.device)
    # the CMF fit is nw tiny host-side values; the H*W*nw work is here
    xyz = img @ torch.tensor(_cmf(wavenumbers), **f32)
    if auto_expose:
        ref = percentile(xyz[..., 1], AUTO_EXPOSE_PERCENTILE)
        xyz = torch.where(ref > 0, xyz / torch.where(ref > 0, ref, 1.0), xyz)
    xyz = xyz * float(np.float32(2.0 ** exposure))
    rgb = xyz @ torch.tensor(_XYZ_TO_SRGB.T, **f32)
    rgb = rgb.clamp(0.0, 1.0)
    srgb = torch.where(rgb <= 0.0031308, 12.92 * rgb,
                       1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return (srgb * 255.0).clamp(0.0, 255.0).to(torch.uint8)


def save_srgb_png(image, wavenumbers, path: str,
                  exposure: float = 0.0) -> None:
    """Write the sRGB image of a [H, W, nw] image (in the format the
    extension names): a ``torch.Tensor`` goes through the device epilogue
    and only uint8 is read back; anything else through the host path."""
    if isinstance(image, torch.Tensor):
        write_image(path, spectral_to_srgb_device(image, wavenumbers,
                                                  exposure=exposure)
                    .cpu().numpy())
        return
    write_image(path, spectral_to_srgb(image, wavenumbers,
                                       exposure=exposure))


_ASCII_RAMP = " .:-=+*#%@"


def ascii_preview(image: np.ndarray, channel: int, width: int = 64,
                  normalize: bool = True) -> str:
    """Terminal preview of one channel (rows subsampled 2:1 for aspect)."""
    gray = (normalized_grayscale(image, channel) if normalize
            else to_grayscale(image, channel)).astype(np.float32) / 255.0
    h, w = gray.shape
    step = max(1, w // width)
    sub = gray[::step * 2, ::step]
    idx = np.clip((sub * (len(_ASCII_RAMP) - 1)).astype(int), 0,
                  len(_ASCII_RAMP) - 1)
    return "\n".join("".join(_ASCII_RAMP[v] for v in row) for row in idx)
