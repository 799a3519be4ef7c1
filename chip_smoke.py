#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, checks the
threefry draw against ``jax.random`` golden values, checks whole traces on
the card against the same traces on the CPU (under shared variates, and
under one key for the spectral modes, textures and grids), then drives
the paths through the entry points a user calls and checks that each went
through its kernels and made a healthy image:

- the main path: the Cornell box at 512x512, 4 wavelengths, trace depth 3,
  64 samples through ``RenderSession.run`` (the dense sweep K1, the
  attribute fetch K2 and the threefry draw);
- the large-scene path: the 51,778-triangle procedural terrain of
  ``bench_suite.terrain_scene`` at 512x512, depth 3, 16 samples through a
  ``RenderSession`` whose ``"auto"`` backend resolves to ``"hier"`` (the
  BVH walk K3, the fetch K2 and the bounce-ray reorder), then 4 samples
  with ``backend="cluster"`` (the cluster-culled sweep K4);
- the spectral path: the dispersion prism of ``bench_suite.prism_scene``
  at 512x512, depth 5, 32 samples with ``dispersion=True`` (K1, K2 with
  the flat hero table, threefry), then the Cornell box at nw = 256,
  8 samples with the hero estimator and without;
- the textured path: ``bench_suite.textured_sphere_scene`` (2,244
  triangles, a checker roughness map) at 1920x1080, 16 samples through
  ``"hier"`` (K3, K2, threefry);
- the user's session: the Cornell box of ``bench_suite`` config 5 at
  3840x2160 through ``RenderSession(chunks=32).run(16, batch=16)`` (K1
  and K2 1 + 16*32*5 = 2561 times each, threefry 16*32*6 = 3072), then
  ``chunks=32`` and ``chunks=1`` timed in turns, 4 samples a step; the
  Cornell box at 512x512 with ``jitter=True``, 16 samples (K1 and K2
  16*6 = 96 times, no hoist; threefry 16*(6+2) = 128), and a 64x64
  one-key jittered trace against the CPU; the terrain through ``"hier"``
  with ``chunks=4``, checkpointed at 8 samples and resumed in a fresh
  session to 16, bitwise the uninterrupted image (K3 and K2 1 + 8*4*5 =
  161 times in the first 8, 160 sorts); stop, restart and the async loop
  (4 samples, paused, ended by stop);
- the user's surface: the main path's box saved to a ``.pts`` file, loaded
  back, rendered by ``cli.main(["render", ...])`` (16 samples, the export,
  the sRGB PNG and a checkpoint checked against the session) and by
  ``python -m pathtracing_spectrum_tpu_torch render`` in a subprocess;
  ``preview_render`` grey and RGB and two picks of the box (one K1 launch
  each) and of the terrain (one K3 launch each), 20 preview frames timed
  on each; ``result_srgb`` of the 4K session within 1 uint8 step of the
  host conversion, both timed, and the 512x512 export timed;
- multi-device rendering on the one card: the main path's box through
  ``RenderSession(sharding=TileSharding(make_mesh()))``, then on a mesh of
  3 entries of the card (tiles of 87,382 rays, the last ending in 2
  zero-direction padding rays) with the terrain 52k through ``"hier"``
  beside it, then ``SppAllreduce`` on a one-rank NCCL group; each image
  bitwise its per-tile ``render_samples(fold_device=g)`` replay, the
  kernels held on the padded tile, and the unsharded, one-device and
  3-entry sessions timed in turns;
- the host's file readers and writers: files that are no image read as
  None and the extensions PIL cannot save raising PIL's exceptions; the
  committed texture fixtures (``tests/torch_data/``: JPEG, CMYK, YCCK and
  arithmetic-coded JPEG, BMP, 8-bit and 1-bit TGA, PNM (P4, 16-bit P5,
  16-bit and maxval-1000 P6, Pf), 16-bit and Adam7 PNG, GIF, TIFF (mode
  I in LZW among them; LZMA, ZSTD and LA JPEG), PSD, WebP, QOI, DXT5 and
  uncompressed DDS, ICO,
  ICNS, JPEG 2000 at PIL's defaults and under its save options: layers,
  progression orders with precincts, tiles at odd offsets, 9/7 with ICT,
  RCT, signed samples) decoded and held to the digests of PIL's decode,
  the JPEG 2000 ones timed, the
  2048x2048 progressive JPEG's, YCCK arithmetic progressive JPEG's,
  Deflate TIFF's and lossy WebP's and the 1024x1024 CMYK arithmetic
  JPEG's and lossless WebP's decodes timed; a 2048x2048 RLE SGI
  roughness map, a 1024x1024 PCX normal map, a 2048x2048 CMYK TIFF
  roughness map and a 1024x1024 PackBits YCbCr TIFF normal map made on
  the machine, each file and its decode held to the digests recorded
  with PIL, the decodes timed, and a 2048x2048 P5 at maxval 65535 and a
  2048x2048 Pf made there, their decodes held to their samples and
  timed; the textured sphere at
  1920x1080 with that JPEG as its roughness map and a 1024x1024 JPEG as
  its normal map, then with the two arithmetic-coded JPEGs, then with the
  TIFF and a 512x512 16-bit LZW TIFF, then with the two WebPs, then with
  the SGI and PCX maps, then with the CMYK and YCbCr TIFFs, then with a
  2048x2048 Group 4 TIFF and a 1024x1024 tiled JPEG-in-TIFF, then with
  a 2048x2048 QOI (written by the port) and a 1024x1024 DXT1 DDS, then
  with the port's ICNS of a 2048x2048 roughness map (read at its
  1024x1024 entry) and its ICO of a 1024x1024 normal map (read at its
  256x256 frame), then with the port's JP2 and JPEG 2000 codestream
  maps, then with a 2048x2048 grey RLE8 BMP roughness map and a 256x256
  ICO normal map whose frame is a 24-bit DIB with an AND mask, then with
  a 2048x2048 BC6H UF16 DDS roughness map and a 1024x1024 BC7 DDS normal
  map of hashed blocks over every mode, then with a 2048x2048 FTEX DXT1
  roughness map and a 1024x1024 BLP2 DXT5 normal map of hashed blocks,
  both made
  on the machine and held to PIL's digests, then with PIL's committed
  9/7 JP2 roughness map of three layers and 9/7 ICT codestream normal
  map in tiles at odd offsets, RPCL with precincts (``j2k-lossy``), then
  with PIL's committed 2048x2048 grey ZSTD roughness map and 1024x1024
  RGB LZMA normal map (``tiff-lzma-zstd``; Python's ``lzma`` checked
  first), then with a 2048x2048 BITPIX 8 FITS roughness map and a
  1024x1024 PIXAR normal map made on the machine (``fits-pixar``), then
  with a 2048x2048 8-bit run-length Sun raster roughness map and a
  1024x1024 RGB XPM normal map of 2-character keys made on the machine
  (``sun-xpm``), then with a 2048x2048 FLC roughness map whose first
  frame is BRUN and a 768x512 PhotoCD normal map made on the machine
  (``fli-pcd``), then with a 2048x2048 float roughness map under Adobe
  Deflate and the floating-point predictor and a 1024x1024 RGB BigTIFF
  normal map under Deflate made on the machine (``tiff-float-big``),
  then with a 2048x2048 CIELab TIFF roughness map under LZW and a
  1024x1024 RLE CIELab PSD normal map made on the machine (``cielab``),
  16 samples each through ``"hier"`` (K3, K2, threefry),
  each texture table on the card bitwise the host decode, timed in turns
  against the checker session (``tiff-lzma-zstd``, ``fits-pixar``,
  ``sun-xpm``, ``fli-pcd``, ``tiff-float-big`` and ``cielab`` by their
  drives alone); the raw-decoder maps made there
  (2048x2048 FITS at BITPIX 8, 16 and -32 and as GZIP_1 tiles, a 2-byte
  McIDAS and a SPIDER file, a 1024x1024 PIXAR and a DCX of a 1024x1024
  PCX page) and the X11 and Sun bitmaps (2048x2048 Sun rasters at 8 bits
  run-length and 24 bits raw and a LinS MSP file, 1024x1024 a GIMP brush
  at depth 4, an XBM and P and RGB XPMs) and the FLI/FLC, PhotoCD and
  IPTC files (a 2048x2048 BRUN FLC, a 2048x2048 FLI of LC and SS2
  chunks, 768x512 PhotoCDs at orientations 0 and 1, a 2048x2048 raw IPTC
  band of an RGB record and a 1024x1024 IPTC record of the port's
  baseline JPEG) and the TIFFs of scientific and GIS tools (2048x2048
  float maps under the floating-point predictor with Adobe Deflate and
  with ZSTD and as an uncompressed BigTIFF, a 1024x1024 RGB BigTIFF under
  Deflate, 2048x2048 12-bit grey maps uncompressed and under LZW, a
  1024x1024 uncompressed map of separate 16-bit RGB planes) and the
  CIELab maps (the two above, a 2048x2048 uncompressed BigTIFF in tiles
  made there and PIL's committed 2048x2048 JPEG TIFF), each file
  and its decode held
  to the digests recorded with PIL (the 16-bit ones to the high-byte
  image of the named deviation, the 12-bit ones to their top 8 bits),
  the decodes timed, and LittleCMS's Lab to sRGB table built there and
  held to the digest of lcms's own, the conversion alone timed;
  ``write_image``'s JPEG,
  BMP, DIB, TIFF, PPM, TGA, GIF, IM, SGI, PCX, WebP, QOI, DDS, EPS, MPO
  and PDF files of a 37x29 and a 3840x2160 image held to the digests of
  PIL's (the PDF's dates pinned), its ICO and ICNS files to PIL's
  directories and frames' pixels, the DIB, IM, SGI, PCX, QOI and DDS
  ones read back by the port equal to the pixels, the MPO equal to the
  JPEG's decode and the ICO and ICNS equal to the frame PIL's reader
  picks, the 4K PCX and SGI decodes and the 4K JPEG, GIF, WebP, QOI,
  DDS, PDF, ICO and ICNS encodes timed, and a 3840x2160 RLE8 BMP, a
  256x256 32-bit CUR, a 128x128 ICNS of ``it32`` and ``t8mk`` entries and
  an ICNS with a JP2 ``ic09`` entry made there, and a 512x512 BLP1 JPEG
  normal map (the port's JPEG) and a 512x512 BLP2 palette map, held to
  PIL's digests and their decodes timed,
  and a preview written as ``v.jpg``, ``v.gif``
  and ``v.webp`` by ``python -m pathtracing_spectrum_tpu_torch`` read
  back (the WebP held to the preview by its PSNR); the 52k and 200k terrains parsed by the native OBJ parser and
  by the plain Python one, bitwise equal, both timed, the 52k one
  rendered through ``"hier"``; a 512x512x4 crop of the 4K session's
  result exported through the native writer and held byte for byte to
  ``format_spectrum``, then the whole 4K result exported and timed;
- the shell: a scripted ``SpectrumShell`` on the card opens the box's
  ``.pts``, renders 4 samples on its async loop, exports, previews and
  autopreviews.

Run from the repository root:

    python3 chip_smoke.py              # one card, about three minutes
    python3 chip_smoke.py --profile    # also print torch.profiler tables

Every check raises on failure, and the script exits non-zero without
printing its result line. It refuses to run without a CUDA device and
without the port's package beside it. Before its result it ends on
purpose (:func:`finish`): no kernel in flight, no thread left. Its last
line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on its path, its error against the plain version, its
time and the plain version's, its bound (the larger of its bytes over the
card's memory rate and its operations over their peak rate; for K3 and K4
the box and triangle tests these rays need, the fewer of the skip-link
and the near-first walk's) and what binds it, and the time of one PyTorch
call of the same function where there is one (K2: ``index_select``).
Every kernel is held to its plain version bit for bit, at the shapes of
each path that runs it (the user's session included: K1 and K2 on the 4K
frame's 8,294,400 primaries and one 259,200-ray chunk, threefry at
[4, 259,200]; K3, K2 and threefry on one 65,536-ray terrain chunk,
sorted as K3 gets it; K1 and K3 on the preview's rays in tile order and
on single pick rays; K1 or K3, K2 and threefry on a sharded session's
padded 87,382-ray tile); K3 and K4 are timed on the terrain primaries, in context on the terrain's bounce-2
rays (the ``kernels`` entry) and on the textured path's bounce-2 rays, K4
beside its counting build's box tests, row-test steps and swept
clusters.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "pathtracing_spectrum_tpu_torch"

RES = 512              # main path: 512x512 pixels ...
DEPTH = 3              # ... trace depth 3 ...
SPP = 64               # ... 64 samples in one render_samples call
TRACE_RES = 64         # shared-variate trace, CUDA vs CPU
AGREE_GATE_PCT = 99.8  # hit agreement gate (bench_suite.AGREE_GATE_PCT)
TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-6
LARGE_SPP = 16         # large-scene path: 16 samples in one call ...
CLUSTER_SPP = 4        # ... then 4 through the cluster backend
PRISM_DEPTH, PRISM_SPP = 5, 32     # spectral path (bench_suite config 2)
NW_BIG, NW_SPP = 256, 8            # Cornell at nw = 256 (config 7)
TEX_RES, TEX_SPP = (1920, 1080), 16  # textured path (config 3)
# the user's session: the 4K frame in 32 chunks, 16 samples in one call
# (bench_suite config 5 on one card), then 4 a step for the rates ...
FOURK_RES, FOURK_CHUNKS, FOURK_SPP, FOURK_RATE_SPP = (3840, 2160), 32, 16, 4
JITTER_SPP = 16          # ... the Cornell box with camera jitter ...
CKPT_CHUNKS, CKPT_SPP = 4, 16   # ... the terrain saved at 8, resumed to 16
ASYNC_SPP, ASYNC_DEADLINE_S = 4, 60.0
# the user's surface: the main path's box as a .pts file rendered by the
# CLI, then preview frames and picks (timed over 20 frames), and the sRGB
# epilogue of the 4K session against the host path (3 turns each)
SURFACE_SPP, PREVIEW_FRAMES, SRGB_TURNS = 16, 20, 3
# multi-device rendering on one card: the main path's box through
# TileSharding (the card's mesh, then 3 entries of it: 2 padding rays) and
# SppAllreduce on a one-rank NCCL group, 16 samples; the terrain through
# "hier" on the 3-entry mesh, 4; then the rates in turns, once each way
MULTI_SPP, MULTI_TERRAIN_SPP, MULTI_RAGGED, MULTI_RATE_TURNS = 16, 4, 3, 1
SHELL_SPP = 4            # the scripted shell's render
# the host's file readers and writers: the committed texture fixtures
# (tools/make_torch_fixtures.py) held by digest, the 2048x2048 JPEG's and
# TIFF's decodes timed (median of 5); the textured 1080p sessions with
# each pair of maps (16 samples each, then 4 a step against the checker
# session in turns); the writers held to PIL's digests, the 4K encodes
# timed (median of 5); the terrains parsed natively and in Python,
# the 52k one rendered through "hier" (4 samples); a 512x512x4 export held
# to the formatter, the 4K one timed
FILES_DIR = os.path.join(HERE, "tests", "torch_data")
FILES_DECODES, FILES_RATE_SPP, FILES_TERRAIN_SPP = 5, 4, 4
# the extensions whose files the files phase reads back as their pixels
# (DIB, IM, SGI, PCX, QOI, DDS, JPEG 2000), those it reads back as the
# JPEG written before them (a single-frame MPO is PIL's JPEG file), and
# those it reads back as the frame PIL's reader picks (ICO: the largest;
# ICNS: ic10)
READ_BACK = (".dib", ".im", ".sgi", ".bw", ".rgb", ".rgba", ".pcx", ".qoi",
             ".dds", ".j2c", ".j2k", ".jp2", ".jpc", ".jpf", ".jpx")
READ_BACK_AS_JPEG = (".mpo",)
READ_BACK_AS_FRAME = (".ico", ".icns")
# the least PSNR the module preview's WebP may have against the grey
# preview: 5 dB below what the same preview gives on the CPU
# (python3 tools/webp_preview_psnr.py: 49.625 dB)
WEBP_PREVIEW_MIN_PSNR = 44.6
FILES_EXPORT_RES = 512
# make_terrain arguments of the repo's terrain assets (make_assets.py)
TERRAINS = {"10k": dict(grid=64, n_rocks=8, rock_sub=8),
            "52k": dict(grid=128, n_rocks=36, rock_sub=12),
            "200k": dict(grid=224, n_rocks=96, rock_sub=20)}
# jax.random (JAX 0.9.0, threefry, partitionable) values for key 5, which
# tests/test_torch_rng.py asserts against jax on the CPU: three folds, the
# first uniforms of each row of the per-bounce [4, 262144] draw under
# fold_in(key, 0), and of the hero draw under fold_in(key, 0x0D15), as
# float32 bit patterns
RNG_GOLDEN = {
    "seed": 5,
    "fold_in": {0: (0xA264258C, 0xD500890A), 3: (0xAF35D4C3, 0xB7629606),
                0x0D15: (0x5553E587, 0x01A567D2)},
    "uniform_fold": 0,
    "uniform_shape": (4, 262144),
    "uniform_bits": ((0x3F29396C, 0x3F600080), (0x3EF465A0, 0x3F6E71D8),
                     (0x3F4E0740, 0x3E623F70), (0x3E88FFA0, 0x3EEDAF84)),
    "hero_bits": (0x3EC95A18, 0x3F678F16, 0x3EFD97F4, 0x3F6C5150),
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def tiny_scene(pt, res: int, depth: int = DEPTH):
    """The JAX package's ``__graft_entry__._tiny_scene`` (the Cornell box of
    ``bench.py``), built with the port's Scene."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("white", [0.8, 0.7, 0.75, 0.8]),
        pt.SpectrumMaterial("emitter", [1.0, 1.0, 1.0, 1.0]),
    ]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(os.path.join(HERE, "assets", "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        hot = el.name == "light"
        sc.set_material(0, i, pt.Material(type=pt.MaterialType.DIFFUSE,
                                          temperature=500.0 if hot else 20.0,
                                          spectrum_mat_id=1 if hot else 0))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def random_soup(torch, dev, n_tris: int, n_rays: int, seed: int):
    """Seeded triangle soup in [-1, 1]^3, reordered by the port's SAH BVH,
    and rays aimed at it from a shell around it; every 7th ray is parked
    (origin 1e30, rd = 0). Returns (planes, tri16, BVH node arrays,
    cluster boxes) on ``dev``."""
    from pathtracing_spectrum_tpu_torch.models.geometry import empty_soa
    from pathtracing_spectrum_tpu_torch.ops import bvh
    from pathtracing_spectrum_tpu_torch.ops.intersect import (
        pack_tri16, precompute_intersect_tables)
    from pathtracing_spectrum_tpu_torch.scene import build_cluster_aabbs
    rng = np.random.default_rng(seed)
    v1 = rng.uniform(-1, 1, (n_tris, 3))
    e1 = rng.normal(0, 0.3, (n_tris, 3))
    e2 = rng.normal(0, 0.3, (n_tris, 3))
    order = bvh.build_bvh(dataclasses.replace(
        empty_soa(), v1=v1.astype(np.float32), e1=e1.astype(np.float32),
        e2=e2.astype(np.float32)))
    v1, e1, e2 = v1[order.tri_order], e1[order.tri_order], e2[order.tri_order]
    fn = np.cross(e1, e2)
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    k1, k2, k3, c = precompute_intersect_tables(v1, e1, e2, fn)
    ro = rng.normal(0, 1, (n_rays, 3))
    ro = 3.0 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
    rd = rng.uniform(-0.5, 0.5, (n_rays, 3)) - ro / 3.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[::7] = 1e30
    rd[::7] = 0.0
    planes = [torch.tensor(a[:, k], dtype=torch.float32, device=dev)
              for a in (ro, rd) for k in range(3)]
    tri16 = pack_tri16(*(torch.tensor(a, dtype=torch.float32, device=dev)
                         for a in (fn, k1, k2, k3, c)))
    v2, v3 = v1 + e1, v1 + e2
    caabb = build_cluster_aabbs(
        np.minimum(np.minimum(v1, v2), v3).astype(np.float32),
        np.maximum(np.maximum(v1, v2), v3).astype(np.float32))
    nodes = [torch.from_numpy(a).to(dev) for a in (
        order.node_min, order.node_max, order.node_skip, order.node_first,
        order.node_count)]
    return planes, tri16, nodes, torch.from_numpy(caabb).to(dev)


def load_by_path(name: str, path: str):
    """Import the module at ``path`` under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_terrain(which: str) -> str:
    """Write ``assets/terrain_<which>.obj`` (git-ignored) with
    ``assets/make_assets.py::make_terrain``, imported by path: its
    ``__main__`` rewrites the checked-in assets and is never run."""
    mod = load_by_path("make_assets",
                       os.path.join(HERE, "assets", "make_assets.py"))
    path = os.path.join(HERE, "assets", f"terrain_{which}.obj")
    mod.make_terrain(path, **TERRAINS[which])
    return path


def rays_of_bounce(scene, ro, rd, h: int):
    """The six ray planes the closest-hit kernel (K1 or K3, as the scene's
    ``"auto"`` backend resolves) gets at bounce iteration ``h`` of a trace
    of ``scene`` under ``rng.key(7)`` (copies; sorted when the bounce-ray
    reorder is on, as the kernel gets them)."""
    import torch
    from pathtracing_spectrum_tpu_torch import engine
    from pathtracing_spectrum_tpu_torch.ops import (
        intersect_cuda, intersect_hier_cuda, rng)
    seen = []
    wrappers = ((intersect_cuda, "intersect_dense"),
                (intersect_hier_cuda, "intersect_bvh"))
    reals = [getattr(mod, name) for mod, name in wrappers]

    def recorder(real):
        def recording(*a, **kw):
            seen.append([p.clone() for p in a[:6]] if len(seen) == h
                        else None)
            return real(*a, **kw)
        recording.launches = 0   # the wrapper counts on its module's name
        return recording

    for (mod, name), real in zip(wrappers, reals):
        setattr(mod, name, recorder(real))
    try:
        engine.trace_radiance(scene, ro, rd, rng.key(7), DEPTH)
        torch.cuda.synchronize()
    finally:
        for (mod, name), real in zip(wrappers, reals):
            setattr(mod, name, real)
    check(len(seen) > h and seen[h] is not None,
          f"no bounce-{h} rays recorded")
    return seen[h]


def terrain_scene(pt, path: str, res: int, depth: int = DEPTH):
    """``bench_suite.terrain_scene`` with the port's Scene: a diffuse
    ground, glossy rocks (roughness 0.3), an emitter panel at 450 C."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("ground", [0.7, 0.75, 0.8, 0.7]),
        pt.SpectrumMaterial("rock", [0.5, 0.55, 0.5, 0.45]),
        pt.SpectrumMaterial("emitter", [1.0] * 4),
    ]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(path)
    mats = {
        "terrain": pt.Material(type=pt.MaterialType.DIFFUSE,
                               spectrum_mat_id=0, temperature=15.0),
        "rocks": pt.Material(type=pt.MaterialType.GLOSSY, spectrum_mat_id=1,
                             temperature=15.0, roughness=0.3),
        "light": pt.Material(type=pt.MaterialType.DIFFUSE, spectrum_mat_id=2,
                             temperature=450.0),
    }
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 4.0, -10.0], [0.0, 0.5, 0.0])
    sc.camera_fovy = 55.0
    return sc


def prism_scene(pt, res: int, depth: int = PRISM_DEPTH):
    """``bench_suite.prism_scene`` with the port's Scene: a Cauchy glass
    prism (ior 1.45, B 0.2) over a floor, a back wall and a 600 C
    emitter."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [pt.SpectrumMaterial("glass", [0.0] * 4),
                             pt.SpectrumMaterial("surface", [0.9] * 4),
                             pt.SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(os.path.join(HERE, "assets", "prism.obj"))
    mats = {"floor": pt.Material(spectrum_mat_id=1, temperature=20.0),
            "back": pt.Material(spectrum_mat_id=1, temperature=20.0),
            "emitter": pt.Material(spectrum_mat_id=2, temperature=600.0),
            "prism": pt.Material(type=pt.MaterialType.GLASS,
                                 spectrum_mat_id=0, temperature=500.0,
                                 ior=1.45, dispersion_b=0.2)}
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 0.5, -4.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 60.0
    return sc


def cornell_nw_scene(pt, res, nw: int, depth: int = DEPTH):
    """``bench_suite.cornell_scene_nw``: the Cornell box over an nw-point
    wavenumber grid from 500 to 2000 1/cm, at ``res`` (width, height). At
    nw = 4 it is ``bench_suite.cornell_scene`` (roughness 0.2 throughout),
    the scene of the 4K configuration."""
    waves = np.linspace(500.0, 2000.0, nw)
    white = np.interp(waves, [500.0, 1000.0, 1500.0, 2000.0],
                      [0.8, 0.7, 0.75, 0.8])
    sc = pt.Scene()
    sc.wavelengths = [float(v) for v in waves]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("white", [float(v) for v in white]),
        pt.SpectrumMaterial("emitter", [1.0] * nw)]
    sc.trace_depth = depth
    sc.resolution = tuple(res)
    obj = sc.load_object(os.path.join(HERE, "assets", "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        hot = el.name == "light"
        sc.set_material(0, i, pt.Material(temperature=500.0 if hot else 20.0,
                                          spectrum_mat_id=1 if hot else 0,
                                          roughness=0.2))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def preview_psnr(view: np.ndarray, grey: np.ndarray) -> float:
    """PSNR in dB of a decoded [H, W, 4] image's colour channels against
    the [H, W] grey preview it was written from."""
    d = view[..., :3].astype(np.float64) - grey[..., None]
    mse = float(np.mean(d * d))
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2
                                                             / mse))


def textured_sphere_scene(pt, res, grid_path: str = "", roughness: str = "",
                          normal: str = ""):
    """``bench_suite.textured_sphere_scene``: a glossy UV sphere with the
    checker roughness map inside the Cornell box (2,244 triangles); with
    ``grid_path`` the box's back wall also carries that temperature
    grid; ``roughness`` replaces the checker map, ``normal`` gives the
    sphere a normal map."""
    assets = os.path.join(HERE, "assets")
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
        pt.SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = DEPTH
    sc.resolution = res
    obj = sc.load_object(os.path.join(assets, "sphere.obj"))
    sc.set_material(0, 0, pt.Material(
        type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
        roughness=0.4,
        roughness_tex_file=roughness or os.path.join(assets, "checker.png")))
    if normal:
        sc.set_normal_texture(0, 0, normal)
    obj.set_location([0.0, 0.0, 3.0])
    box = sc.load_object(os.path.join(assets, "cornell_box.obj"))
    for i, el in enumerate(box.elements):
        hot = el.name == "light"
        sc.set_material(1, i, pt.Material(temperature=400.0 if hot else 15.0,
                                          spectrum_mat_id=1 if hot else 0))
        if grid_path and el.name == "back":
            sc.set_temperature_data(1, i, grid_path)
    sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 55.0
    return sc


def healthy(img, what: str) -> None:
    check(bool(np.isfinite(img).all()), f"{what}: image has non-finite "
          "values")
    check(bool((img >= 0).all()), f"{what}: image has negative values")
    check(img.mean() > 0, f"{what}: image is black")


def agreement(got, want):
    """(hit/idx agreement %, max |d| of t, s2, s3 where they agree, rays
    with a hit) of two (hit, t, idx, s2, s3) results."""
    agree = (got[2] == want[2]) & (got[0] == want[0])
    pct = agree.float().mean().item() * 100.0
    err = max((got[j] - want[j]).abs()[agree].max().item()
              for j in (1, 3, 4))
    return pct, err, int(want[0].sum())


def time_fn(torch, fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn``, with CUDA events around ``iters``
    calls after a warmup.

    A spin kernel queued first keeps the card busy while the host issues
    the timed calls, so the events bracket back-to-back device work: a
    wrapper's Python overhead (tens of µs) would otherwise exceed the
    kernel's own time and be measured in its place. A function that waits
    for the device inside (the hierarchical plain versions do) ends the
    spin early; its time then includes its own host waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)     # ~50 ms of spinning at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_pair(torch, kernel, plain, iters: int = 50, plain_iters: int = 0,
              plain_warmup: int = 3):
    """Mean device ms per call of ``kernel`` and ``plain`` (:func:`time_fn`),
    measured in turns (plain, kernel, kernel, plain);
    ``plain_iters``/``plain_warmup`` shorten the plain version's loop
    (0: as the kernel's)."""
    pn = plain_iters or iters
    p1 = time_fn(torch, plain, pn, plain_warmup)
    k1, k2 = time_fn(torch, kernel, iters), time_fn(torch, kernel, iters)
    p2 = time_fn(torch, plain, pn, plain_warmup)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---- bounds: the least time the card could take for a kernel's work ------
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA H100
# datasheet): device memory and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# 32-bit integer adds, logic and shifts an SM issues per clock on Hopper
# (CUDA C++ Programming Guide, arithmetic instruction throughput, cc 9.0)
INT32_OPS_PER_CLK_SM = 64
# float operations of one test, counted in csrc/tri_hit.cuh: a triangle
# test is rd.n (5), ro.n (5), c0 - ro.n (1), the division (1), p (6) and
# s1..s3 (18); a box test is 3 axes x 2 subtractions and 2 multiplies
# (12) and the two relax() (4)
TRI_TEST_OPS = 36
BOX_TEST_OPS = 16
# integer operations of one threefry element (csrc/threefry.cu): 20 rounds
# of add, funnel shift and xor (60), 6 key injections of 2 adds (12), ks2
# (2 xors), the bits (xor, shift, or: 3)
THREEFRY_INT_OPS = 77
RAY_BYTES = 24                      # six float32 planes in ...
HIT_BYTES = 17                      # ... hit, t, idx, s2, s3 out


def bound(nbytes: float, ops: float = 0.0,
          ops_per_s: float = FP32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def walk_ops(boxes: int, tris: int) -> int:
    return boxes * BOX_TEST_OPS + tris * TRI_TEST_OPS


def want_counts(n, depth, hero=False, route="intersect_dense", sorts=0,
                chunks=1, jitter=False):
    """Launches of one render_samples call of n samples: the primary hit
    and its fetch hoisted once on the whole frame (not with jitter: each
    sample intersects its own primaries), then each chunk's looped
    iterations on the closest-hit kernel and K2 (plus one hero-table read
    per iteration); one threefry draw per iteration (plus the hero
    channel's per chunk, and jitter's two per sample)."""
    hits = n * chunks * (2 * depth - (0 if jitter else 1)) + (not jitter)
    want = {"intersect_dense": 0, "intersect_bvh": 0,
            "intersect_cluster": 0, "sorts": sorts,
            "fetch_rows": hits + (n * chunks * 2 * depth if hero else 0),
            "threefry_uniform": (n * chunks * (2 * depth + (1 if hero else 0))
                                 + (2 * n if jitter else 0))}
    want[route] = hits
    return want


def timed_step(torch, sess, n: int):
    """(Mrays/s, ms per sample) of one more ``step(n)`` of ``sess``, timed
    with CUDA events; the step ends by reading its ray count."""
    torch.cuda.synchronize()
    rays0 = sess.rays_traced
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    sess.step(n, readback=False)
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1)
    return (sess.rays_traced - rays0) / ms / 1e3, ms / n


def drive(torch, sess, n, counts, zero_counts):
    """``sess.run(n, batch=n)`` with the launch counts set to 0 just before
    and read just after: (image, counts)."""
    sess.start()
    torch.cuda.synchronize()
    zero_counts()
    img = sess.run(n, batch=n)
    torch.cuda.synchronize()
    return img, counts()


def lit_from_top(img, what: str) -> None:
    healthy(img, what)
    h = img.shape[0]
    check(img[: h // 8].mean() > img[-(h // 8):].mean(),
          f"{what}: image is not lit from the top")


def hold(label: str, case: str, got, want) -> float:
    """Check one kernel call bitwise against its plain version on the same
    inputs (float32 outputs compared as bits) and print the case; returns
    the largest absolute difference over the outputs."""
    import torch
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    torch.cuda.synchronize()

    def bits(a):
        return a.view(torch.int32) if a.dtype == torch.float32 else a

    same = all(a.shape == b.shape and torch.equal(bits(a), bits(b))
               for a, b in zip(got, want))
    err = max((a.double() - b.double()).abs().max().item()
              for a, b in zip(got, want))
    say(label, case=case, shape=list(got[0].shape), bitwise_equal=same,
        max_abs_err=err, gate="bitwise")
    check(same, f"{label} is not bitwise its plain version on {case}")
    return err


def tri16_of(data):
    """The packed [T, 16] triangle table of a compiled scene."""
    from pathtracing_spectrum_tpu_torch.ops.intersect import pack_tri16
    return pack_tri16(data.tri_face_n, data.tri_k1, data.tri_k2,
                      data.tri_k3, data.tri_consts)


def hier_tables(data):
    """(packed [T, 16] table, node arrays, packed node records) of a
    compiled scene: K3's inputs."""
    from pathtracing_spectrum_tpu_torch.ops import intersect_hier_cuda
    nodes = (data.bvh_node_min, data.bvh_node_max, data.bvh_node_skip,
             data.bvh_node_first, data.bvh_node_count)
    return tri16_of(data), nodes, intersect_hier_cuda.pack_bvh(*nodes)


def planes_of(ro, rd):
    """The six contiguous [N] ray planes of [N, 3] origins and
    directions."""
    return [ro[:, k].contiguous() for k in range(3)] + \
        [rd[:, k].contiguous() for k in range(3)]


def chunks_4k_phase(torch, pt, dev, card, counts, zero_counts,
                    res=FOURK_RES, chunks=FOURK_CHUNKS, spp=FOURK_SPP,
                    rate_spp=FOURK_RATE_SPP, with_profile=False):
    """The 4K Cornell box (``bench_suite`` config 5 on one card) through
    ``RenderSession(chunks=32).run(16, batch=16)``: one K1/K2 call on the
    whole frame, then 32 chunks of 259,200 rays a sample. K1, K2 and
    threefry are then held to their plain versions at this path's shapes:
    K1 and K2 on the session's 8,294,400 primaries and on one chunk's
    bounce-2 rays (259,200, a ragged last block), threefry at [4, 259,200].
    Then the rates of ``chunks=32`` and ``chunks=1`` in turns, ``rate_spp``
    samples a step. Returns the largest error of each kernel held and the
    16-sample session (its accumulator feeds the sRGB epilogue)."""
    from pathtracing_spectrum_tpu_torch import engine
    from pathtracing_spectrum_tpu_torch.ops import (fetch_cuda,
                                                    intersect_cuda, rng,
                                                    rng_cuda)
    sc = cornell_nw_scene(pt, res, 4)
    warm = pt.RenderSession(sc, dev, seed=1, chunks=chunks)
    warm.run(1, batch=1)
    del warm
    sess = pt.RenderSession(sc, dev, seed=0, chunks=chunks)
    img, got = drive(torch, sess, spp, counts, zero_counts)
    st = sess.stats()
    want = want_counts(spp, DEPTH, chunks=chunks)
    say("4k-chunks", res=f"{res[0]}x{res[1]}", chunks=chunks,
        rays_per_chunk=res[0] * res[1] // chunks, depth=DEPTH, spp=spp,
        backend=st["backend"], launches=json.dumps(got),
        expected=json.dumps(want), rays_traced=st["rays_traced"],
        session_mrays_per_s=st["mrays_per_s"],
        session_ms_per_sample=1e3 * st["avg_time_per_sample_s"],
        mean=float(img.mean()), card=repr(card))
    check(st["backend"] == "dense", f"4K resolved {st['backend']}")
    check(got == want, f"4k-chunks launches {got}, expected {want}")
    check(img.shape == (res[1], res[0], 4), f"4K image shape {img.shape}")
    lit_from_top(img, "4k-chunks")

    data = sess._scene_data
    prep = engine._prepare(data, "auto")
    tri16 = tri16_of(data)
    nc = sess._ro.shape[0] // chunks
    errs = {"intersect_dense": 0.0, "fetch_rows": 0.0,
            "threefry_uniform": 0.0}
    for case, planes in (
            ("4k-primaries", planes_of(sess._ro, sess._rd)),
            ("4k-chunk-bounce2", rays_of_bounce(data, sess._ro[-nc:],
                                                sess._rd[-nc:], 2))):
        hit = intersect_cuda.intersect_dense(*planes, tri16)
        errs["intersect_dense"] = max(errs["intersect_dense"], hold(
            "K1", case, hit,
            intersect_cuda.intersect_dense_ref(*planes, tri16)))
        errs["fetch_rows"] = max(errs["fetch_rows"], hold(
            "K2", case, fetch_cuda.fetch_rows(hit[2], prep.shade_sub),
            fetch_cuda.fetch_rows_ref(hit[2], prep.shade_sub)))
        del hit, planes
    # the last chunk's key of sample 0
    k = rng.fold_in(rng.fold_in(rng.key(0), 0),
                    engine.CHUNK_FOLD + chunks - 1)
    errs["threefry_uniform"] = hold(
        "rng", "4k-chunk", rng_cuda.uniform(k, (4, nc), dev),
        rng.uniform_ref(k, (4, nc), dev))

    one = pt.RenderSession(sc, dev, seed=0)          # chunks=1
    one.run(1, batch=1)
    rates = {1: [], chunks: []}
    for s, c in ((one, 1), (sess, chunks), (sess, chunks), (one, 1)):
        rates[c].append(timed_step(torch, s, rate_spp))
    for c, vals in rates.items():
        say("4k-chunks", chunks=c, spp_per_step=rate_spp,
            mrays_per_s=[v[0] for v in vals],
            ms_per_sample=[v[1] for v in vals], card=repr(card))
    if with_profile:
        for s, c in ((sess, chunks), (one, 1)):
            profile(torch, s, min(v[1] for v in rates[c]),
                    f"4k-chunks{c}")
    return errs, sess


def jitter_phase(torch, pt, dev, card, counts, zero_counts, res=RES,
                 spp=JITTER_SPP, with_profile=False):
    """The Cornell box with camera jitter through
    ``RenderSession(jitter=True).run(16, batch=16)``: no primary hoist, two
    [N] threefry draws a sample for the offsets. Then the jittered and the
    pixel-corner sessions timed in turns. Returns the counts."""
    sc = tiny_scene(pt, res)
    sess = pt.RenderSession(sc, dev, seed=0, jitter=True)
    img, got = drive(torch, sess, spp, counts, zero_counts)
    st = sess.stats()
    want = want_counts(spp, DEPTH, jitter=True)
    plain = pt.RenderSession(sc, dev, seed=0)        # the pixel corners
    corners = plain.run(spp, batch=spp)
    rel = abs(float(img.mean()) - float(corners.mean())) / corners.mean()
    say("jitter", res=f"{res}x{res}", spp=spp, backend=st["backend"],
        launches=json.dumps(got), expected=json.dumps(want),
        mean=float(img.mean()), corners_mean=float(corners.mean()),
        rel_mean_diff=rel)
    rates = {"corners": [], "jitter": []}
    for s, name in ((plain, "corners"), (sess, "jitter"), (sess, "jitter"),
                    (plain, "corners")):
        rates[name].append(timed_step(torch, s, spp))
    for name, vals in rates.items():
        say("jitter", rays=name, spp_per_step=spp,
            mrays_per_s=[v[0] for v in vals],
            ms_per_sample=[v[1] for v in vals], card=repr(card))
    if with_profile:
        profile(torch, sess, min(v[1] for v in rates["jitter"]), "jitter")
    check(got == want, f"jitter launches {got}, expected {want}")
    check(img.shape == (res, res, 4), f"jitter image shape {img.shape}")
    lit_from_top(img, "jitter")
    check(not np.array_equal(img, corners),
          "the jittered image is the pixel-corner image")
    check(rel < 0.1, f"jittered mean {rel:.3f} away from the corners'")
    return got


def jitter_trace(torch, pt, dev, res=TRACE_RES):
    """One jittered sample of ``render_samples(jitter_cam=...)`` under one
    key at ``res``², on the card and on the CPU: the rays of each pixel
    that hit the same triangles on both agree within the trace
    tolerance."""
    from pathtracing_spectrum_tpu_torch import engine
    from pathtracing_spectrum_tpu_torch.ops import fetch_cuda, rng
    sc = tiny_scene(pt, res)
    ro, rd = pt.camera_rays(sc.camera(), res, res, "cpu")
    n = ro.shape[0]
    fetched, out, side = {}, {}, [None]
    real_fetch = fetch_cuda.fetch_rows

    def recording_fetch(idx, table):
        fetched.setdefault(side[0], []).append(idx.cpu())
        return real_fetch(idx, table)

    recording_fetch.launches = 0
    fetch_cuda.fetch_rows = recording_fetch
    try:
        for side[0], d in (("cpu", "cpu"), ("cuda", dev)):
            jc = pt.jitter_cam_arrays(sc.camera(), res, res, device=d)
            out[side[0]] = engine.render_samples(
                sc.compile(d), ro.to(d), rd.to(d),
                torch.zeros((n, 4), device=d), 0, rng.key(13), 1,
                n_steps=1, max_depth=DEPTH, jitter_cam=jc)
        torch.cuda.synchronize()
    finally:
        fetch_cuda.fetch_rows = real_fetch
    differs = torch.zeros(n, dtype=torch.bool)
    for ic, idd in zip(fetched["cpu"], fetched["cuda"]):
        differs |= ic != idd
    a, b = out["cuda"][0].cpu()[~differs], out["cpu"][0][~differs]
    close = torch.allclose(a, b, rtol=TRACE_RTOL, atol=TRACE_ATOL)
    n_diff = int(differs.sum())
    say("trace", scene="cornell-jitter", key="key(13), counter 1",
        pixels=n, depth=DEPTH, bounces=len(fetched["cuda"]),
        pixels_with_other_hits=n_diff,
        max_abs_diff_elsewhere=(a - b).abs().max().item(),
        rays_cuda=int(out["cuda"][3]), rays_cpu=int(out["cpu"][3]),
        tolerance=f"rtol={TRACE_RTOL},atol={TRACE_ATOL}")
    check(len(fetched["cuda"]) == len(fetched["cpu"]) == 2 * DEPTH,
          "the jittered trace did not fetch once per bounce (no hoist)")
    check(close, "jitter: CUDA and CPU traces differ beyond tolerance")
    check(n_diff <= n * (100.0 - AGREE_GATE_PCT) / 100.0,
          f"jitter: {n_diff} pixels hit other triangles on the card")


def checkpoint_phase(torch, pt, dev, card, counts, zero_counts, sc_terrain,
                     sc_small, chunks=CKPT_CHUNKS, spp=CKPT_SPP):
    """The terrain through ``"auto"`` (``"hier"``: K3, K2, the reorder)
    with ``chunks=4``: 8 samples, a checkpoint, 8 more; a fresh session
    loads the checkpoint and runs to 16, bitwise the uninterrupted image.
    Then the state machine on ``sc_small``: stop and start reset, restart
    resets, and the async loop reaches ``ASYNC_SPP`` samples, pauses, and
    ends on stop. K3, K2 and threefry are held to their plain versions on
    one 65,536-ray chunk (its sorted bounce-2 rays, its [4, 65,536] draw).
    Returns the largest error of each kernel held."""
    from pathtracing_spectrum_tpu_torch import engine
    from pathtracing_spectrum_tpu_torch.ops import (
        fetch_cuda, intersect_hier_cuda, rng, rng_cuda)
    from pathtracing_spectrum_tpu_torch.render import RenderStatus
    k3_fn = intersect_hier_cuda.intersect_bvh
    half = spp // 2
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "terrain.npz")
        a = pt.RenderSession(sc_terrain, dev, seed=5, chunks=chunks)
        _, got = drive(torch, a, half, counts, zero_counts)
        want = want_counts(half, DEPTH, route="intersect_bvh",
                           sorts=half * chunks * (2 * DEPTH - 1),
                           chunks=chunks)
        a.save_checkpoint(path)
        full = a.run(spp)
        b = pt.RenderSession(sc_terrain, dev, seed=0, chunks=chunks)
        b.start()
        b.load_checkpoint(path)
        resumed_at = (b.samples, b.seed, b.status.value)
        resumed = b.run(spp)
    torch.cuda.synchronize()
    same = np.array_equal(resumed, full)
    say("checkpoint", scene="terrain-52k", res="x".join(
        map(str, sc_terrain.resolution)), backend=a.stats()["backend"],
        chunks=chunks, saved_at=half, resumed_at=list(resumed_at),
        samples=[a.samples, b.samples], launches=json.dumps(got),
        expected=json.dumps(want), bitwise_equal=same,
        max_abs_diff=float(np.abs(resumed - full).max()),
        mean=float(full.mean()), card=repr(card))
    check(a.stats()["backend"] == "hier", "the terrain did not resolve hier")
    check(got == want, f"checkpoint-phase launches {got}, expected {want}")
    check(resumed_at == (half, 5, "paused"),
          f"the checkpoint resumed at {resumed_at}")
    check(a.samples == b.samples == spp, "samples after the resume")
    healthy(full, "terrain chunks=4")
    check(same, "the resumed terrain image is not bitwise the "
          "uninterrupted one")

    # K3, K2 and threefry at this path's shapes: one 65,536-ray chunk's
    # bounce-2 rays, sorted as K3 gets them
    data = a._scene_data
    tri16, nodes, packed = hier_tables(data)
    nc = a._ro.shape[0] // chunks
    planes = rays_of_bounce(data, a._ro[:nc], a._rd[:nc], 2)
    hit = k3_fn(*planes, tri16, packed)
    shade = engine._prepare(data, "auto").shade_sub
    k = rng.fold_in(rng.fold_in(rng.key(5), 0), engine.CHUNK_FOLD)
    errs = {"intersect_bvh": hold(
                "K3", "terrain-chunk-bounce2", hit,
                intersect_hier_cuda.intersect_bvh_ref(*planes, tri16,
                                                      *nodes)),
            "fetch_rows": hold(
                "K2", "terrain-chunk-bounce2",
                fetch_cuda.fetch_rows(hit[2], shade),
                fetch_cuda.fetch_rows_ref(hit[2], shade)),
            "threefry_uniform": hold(
                "rng", "terrain-chunk", rng_cuda.uniform(k, (4, nc), dev),
                rng.uniform_ref(k, (4, nc), dev))}
    del planes, hit

    s = pt.RenderSession(sc_small, dev, seed=0)
    s.run(2, batch=2)
    s.stop()
    stopped = s.status
    s.start()
    check(stopped == RenderStatus.STOPPED and s.samples == 0
          and not bool(s._total.any()), "stop -> start did not reset")
    s.step(1, readback=False)
    s.restart()
    check(s.samples == 0 and s.status == RenderStatus.RENDERING,
          "restart did not reset")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    s.start_async(ASYNC_SPP)
    deadline = t0 + ASYNC_DEADLINE_S
    while s.status != RenderStatus.PAUSED and time.perf_counter() < deadline:
        time.sleep(0.01)
    paused_s = time.perf_counter() - t0
    got_async = counts()
    paused = (s.status, s.samples)
    s.stop()
    s.join(timeout=ASYNC_DEADLINE_S)
    alive = s._thread.is_alive()
    want_async = {k: ASYNC_SPP * v for k, v in want_counts(1, DEPTH).items()}
    say("session", async_target=ASYNC_SPP, paused_after_s=paused_s,
        status=paused[0].value, samples=paused[1],
        launches=json.dumps(got_async), expected=json.dumps(want_async),
        thread_alive_after_join=alive)
    check(paused == (RenderStatus.PAUSED, ASYNC_SPP),
          f"the async loop stood at {paused}, not paused at {ASYNC_SPP}")
    check(got_async == want_async, f"async launches {got_async}")
    check(not alive, "the async thread outlived stop() and join()")
    healthy(s.result(), "async")
    return errs


def scene_file_render(torch, pt, dev, card, counts, zero_counts, sc, tmp,
                      spp=SURFACE_SPP):
    """``sc`` saved to a ``.pts`` and loaded back (the digest equal once the
    fields a ``.pts`` does not carry are copied over), then rendered by
    ``cli.main(["render", ...])`` in-process, with the counts set to 0 just
    before and read just after. Checks the launches against those of the
    session's ``step`` calls, the exported text against ``result()`` to
    ``%g`` precision, the sRGB PNG against ``result_srgb()`` and the
    checkpoint; times the export of ``result()`` once. Returns (the
    launches, the session, the .pts path)."""
    import contextlib
    import io
    from pathtracing_spectrum_tpu_torch import cli, render
    from pathtracing_spectrum_tpu_torch.utils import scene_io, spectral_io
    from pathtracing_spectrum_tpu_torch.utils.image import load_rgba
    pts = os.path.join(tmp, "scene.pts")
    scene_io.save_scene(sc, pts)
    back = scene_io.load_scene(pts)
    back.camera_fovy, back.camera_focal = sc.camera_fovy, sc.camera_focal
    for ob, os_ in zip(back.objects, sc.objects):
        for eb, es in zip(ob.elements, os_.elements):
            for field in ("ior", "dispersion_b", "roughness_tex_file",
                          "temperature_data_file"):
                setattr(eb.material, field, getattr(es.material, field))
    same_digest = back.content_digest() == sc.content_digest()

    made, steps = [], []
    real_session = render.RenderSession

    class Recorded(real_session):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def step(self, n_samples=1, readback=True):
            steps.append(n_samples)
            return super().step(n_samples, readback)

    txt, png, npz = (os.path.join(tmp, f"cli.{e}") for e in
                     ("txt", "png", "npz"))
    out = io.StringIO()
    render.RenderSession = Recorded
    try:
        torch.cuda.synchronize()
        zero_counts()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["render", pts, "--spp", str(spp), "--out", txt,
                           "--png-srgb", png, "--checkpoint", npz,
                           "--quiet", "--device", str(dev)])
        torch.cuda.synchronize()
        got = counts()
    finally:
        render.RenderSession = real_session
    sess = made[0]
    want = {k: sum(want_counts(n, sc.trace_depth)[k] for n in steps)
            for k in got}
    img = sess.result()
    w, h = sess.resolution
    exported = spectral_io.import_spectrum(txt, w, h, img.shape[2])
    pct_err = float(np.max(np.abs(exported - img)
                           / np.maximum(np.abs(img), 1e-30)))
    srgb = sess.result_srgb()
    png_rgb = np.round(load_rgba(png)[..., :3] * 255.0).astype(np.uint8)
    ck = np.load(npz)
    t0 = time.perf_counter()
    spectral_io.export_spectrum(os.path.join(tmp, "again.txt"), img)
    export_s = time.perf_counter() - t0
    say("surface", pts=os.path.basename(pts), digest_equal=same_digest,
        cli_rc=rc, res=f"{w}x{h}", spp=sess.samples, steps=steps,
        backend=sess.stats()["backend"], launches=json.dumps(got),
        expected=json.dumps(want), export_max_rel_err=pct_err,
        png_equals_result_srgb=bool(np.array_equal(png_rgb, srgb)),
        checkpoint_samples=int(ck["samples"]), mean=float(img.mean()))
    for line in out.getvalue().splitlines():
        say("surface", cli_stdout=repr(line))
    say("surface", export=f"{w}x{h}x{img.shape[2]}",
        export_values=int(img.size), export_s=export_s,
        export_mb=os.path.getsize(txt) / 1e6, card=repr(card))
    check(same_digest, "the loaded .pts has another content_digest")
    check(rc == 0 and sess.samples == spp, f"cli render rc {rc}, "
          f"{sess.samples} samples")
    check(got == want, f"cli render launches {got}, expected {want}")
    check(pct_err <= 5.1e-6, f"the export is {pct_err} off result()")
    check(np.array_equal(png_rgb, srgb), "the sRGB PNG is not result_srgb()")
    check(int(ck["samples"]) == spp, "the checkpoint's sample count")
    healthy(img, "cli render")
    return got, sess, pts


def preview_holds(torch, pt, dev, card, counts, zero_counts, name, sc, data,
                  res, frames=PREVIEW_FRAMES):
    """``preview_render`` grey and RGB and two picks (below the centre and
    a corner) of ``sc`` at ``res``² on ``dev``: each one launch of the
    scene's closest-hit kernel, K1 at up to 512 triangles, K3 above, and no
    other. Then that kernel held bitwise against its plain version on the
    preview's rays (in tile order) and on the picks' single rays, and the
    grey frame timed over ``frames`` (median). Returns (kernel name, its
    launches, the largest error)."""
    from pathtracing_spectrum_tpu_torch import preview
    from pathtracing_spectrum_tpu_torch.models.camera import tile_order
    from pathtracing_spectrum_tpu_torch.ops import (intersect_cuda,
                                                    intersect_hier_cuda)
    dense = pt.resolve_backend("auto", data.n_triangles, dev) == "dense"
    kname, label = (("intersect_dense", "K1") if dense
                    else ("intersect_bvh", "K3"))
    sc.select_object(0)
    sc.set_highlight(0, 0, True)
    lower = 3 * res // 4      # the terrain's horizon is near mid-frame
    launches = 0
    for what, call in (
            ("grey", lambda: preview.preview_render(sc, res, res, data,
                                                    device=dev)),
            ("rgb", lambda: preview.preview_render(sc, res, res, data,
                                                   rgb=True, device=dev)),
            ("pick-lower", lambda: preview.pick(sc, res, res, res // 2,
                                                lower, data, device=dev)),
            ("pick-corner", lambda: preview.pick(sc, res, res, 0, 0, data,
                                                 device=dev))):
        torch.cuda.synchronize()
        zero_counts()
        out = call()
        torch.cuda.synchronize()
        got = counts()
        want = {k: 0 for k in got}
        want[kname] = 1
        image = isinstance(out, np.ndarray)
        say("preview", scene=name, call=what, launches=json.dumps(got),
            result=list(out.shape) if image else list(out),
            lit_pct=100.0 * float((out > 0).mean()) if image else None)
        check(got == want, f"{name} preview {what} launches {got}")
        check((out > 0).mean() > 0.2 if image
              else out[0] in ((0,) if what == "pick-lower" else (0, -1)),
              f"{name} {what} gave {out if not image else 'black'}")
        launches += got[kname]

    tri16 = tri16_of(data)
    if dense:
        def kernel(planes):
            return intersect_cuda.intersect_dense(*planes, tri16)

        def plain(planes):
            return intersect_cuda.intersect_dense_ref(*planes, tri16)
    else:
        _, nodes, packed = hier_tables(data)

        def kernel(planes):
            return intersect_hier_cuda.intersect_bvh(*planes, tri16, packed)

        def plain(planes):
            return intersect_hier_cuda.intersect_bvh_ref(*planes, tri16,
                                                         *nodes)
    ro, rd = pt.camera_rays(sc.camera(), res, res, "cpu")
    perm, _ = tile_order(res, res)
    perm_t = torch.from_numpy(perm.astype(np.int64))
    err = 0.0
    for case, idx in (("preview", perm_t),
                      ("pick", torch.tensor([lower * res + res // 2])),
                      ("pick", torch.tensor([0]))):
        planes = planes_of(ro[idx].to(dev), rd[idx].to(dev))
        err = max(err, hold(label, case, kernel(planes), plain(planes)))

    times = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preview.preview_render(sc, res, res, data, device=dev)
        times.append((time.perf_counter() - t0) * 1e3)
    say("preview", scene=name, res=f"{res}x{res}", tris=data.n_triangles,
        kernel=label, frames=frames, median_ms=float(np.median(times)),
        min_ms=min(times), max_ms=max(times), card=repr(card))
    sc.select_object(0, False)
    sc.set_highlight(0, 0, False)
    return kname, launches, err


def srgb_epilogue(torch, pt, card, sess, turns=SRGB_TURNS):
    """``result_srgb()`` of ``sess`` (the epilogue on the card, [N, 3]
    uint8 read back) within 1 uint8 step of ``spectral_to_srgb(result())``
    (the [N, nw] float32 read back, float64 on the host). The session's
    thermal-IR wavenumbers map to black, so the same accumulator is then
    read as visible samples (450, 520, 590 and 650 nm): held to the same
    step, and both paths timed on the host clock in turns (host, card,
    card, host, ...)."""
    from pathtracing_spectrum_tpu_torch import viewer
    ir = sess.result_srgb()
    diff_ir = int(np.abs(ir.astype(np.int32) - viewer.spectral_to_srgb(
        sess.result(), sess.scene.wavelengths)).max())
    waves = sess.scene.wavelengths
    sess.scene.wavelengths = [1e7 / nm for nm in (450.0, 520.0, 590.0,
                                                  650.0)]
    times = {"card": [], "host": []}
    try:
        order = ["host", "card", "card", "host"] * ((turns + 1) // 2)
        for which in order[:2 * turns]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "card":
                dev_img = sess.result_srgb()
            else:
                host_img = viewer.spectral_to_srgb(sess.result(),
                                                   sess.scene.wavelengths)
            times[which].append((time.perf_counter() - t0) * 1e3)
    finally:
        sess.scene.wavelengths = waves
    diff = int(np.abs(dev_img.astype(np.int32) - host_img).max())
    n = sess._out.shape[0]
    say("srgb", res="x".join(map(str, sess.resolution)), samples=sess.samples,
        thermal_max_step_diff=diff_ir,
        thermal_nonzero_pct=100.0 * float((ir > 0).mean()),
        visible_max_step_diff=diff,
        visible_nonzero_pct=100.0 * float((dev_img > 0).mean()),
        readback_mb_card=n * 3 / 1e6,
        readback_mb_host=n * sess._out.shape[1] * 4 / 1e6,
        card_ms=times["card"], host_ms=times["host"], card=repr(card))
    check(dev_img.shape == host_img.shape == ir.shape
          == (sess.resolution[1], sess.resolution[0], 3),
          f"sRGB shape {dev_img.shape}")
    check(diff_ir <= 1 and diff <= 1, f"the sRGB epilogue is {diff_ir} "
          f"(thermal) and {diff} (visible) steps off the host path")
    check((dev_img > 0).mean() > 0.5, "the visible sRGB image is black")
    return diff


def surface_phase(torch, pt, dev, card, counts, zero_counts, cornell,
                  terrain, sess_4k, res=RES, spp=SURFACE_SPP,
                  frames=PREVIEW_FRAMES, module_timeout=600):
    """The user's surface on the card: a ``.pts`` file rendered by the CLI
    in-process and by ``python -m pathtracing_spectrum_tpu_torch render``
    in a subprocess; preview frames and picks of the Cornell box (K1) and
    the terrain (K3), their kernels held on the preview and pick rays; the
    sRGB epilogue of the 4K session against the host path. ``cornell`` and
    ``terrain`` are (Scene, its SceneData on ``dev``). Returns (the
    launches of each kernel, the largest error of each kernel held)."""
    with tempfile.TemporaryDirectory() as tmp:
        got, _, pts = scene_file_render(torch, pt, dev, card, counts,
                                        zero_counts, cornell[0], tmp, spp)
        t0 = time.perf_counter()
        res_m = subprocess.run(
            [sys.executable, "-m", PKG, "render", pts, "--spp", str(spp),
             "--out", os.path.join(tmp, "module.txt"), "--quiet",
             "--device", str(dev)], capture_output=True, text=True,
            timeout=module_timeout, cwd=HERE)
        lines = res_m.stdout.strip().splitlines()
        stats = json.loads(lines[-1]) if res_m.returncode == 0 else {}
        say("surface", module_rc=res_m.returncode,
            module_seconds=time.perf_counter() - t0,
            module_stats=json.dumps(stats),
            module_stderr=repr(res_m.stderr[-500:]))
        check(res_m.returncode == 0, "python -m render failed")
        check(stats.get("device") == str(dev) and stats["samples"] == spp,
              f"python -m render stats {stats}")
    launches, errs = dict(got), {}
    for name, (sc, data) in (("cornell", cornell), ("terrain", terrain)):
        kname, n, err = preview_holds(torch, pt, dev, card, counts,
                                      zero_counts, name, sc, data, res,
                                      frames)
        launches[kname] += n
        errs[kname] = max(errs.get(kname, 0.0), err)
    srgb_epilogue(torch, pt, card, sess_4k)
    return launches, errs


def picked_frame(data: bytes) -> bytes:
    """The PNG frame PIL's reader loads from an ICO or ICNS file PIL or the
    port writes: the ICO frame of the largest area (the first of those,
    all 32 bits), the ICNS ``ic10`` entry."""
    if data.startswith(b"icns"):
        pos = 8
        while pos < len(data):
            kind, length = struct.unpack_from(">4sI", data, pos)
            if kind == b"ic10":
                return data[pos + 8:pos + length]
            pos += length
        raise ValueError("no ic10 entry")
    entries = [struct.unpack_from("<BBxxxxxxII", data, 6 + 16 * i)
               for i in range(struct.unpack_from("<H", data, 4)[0])]
    w, h, length, offset = max(entries,
                               key=lambda e: (e[0] or 256) * (e[1] or 256))
    return data[offset:offset + length]


def files_phase(torch, pt, dev, card, counts, zero_counts, sess_4k,
                res=TEX_RES, spp=TEX_SPP, rate_spp=FILES_RATE_SPP,
                terrains=("52k", "200k"), terrain_res=RES,
                terrain_spp=FILES_TERRAIN_SPP, export_res=FILES_EXPORT_RES,
                decodes=FILES_DECODES):
    """The host's file readers and writers, driven on the card's machine:

    - four files that are no image (an HTML page, zeros, noise, a RIFF
      WAVE header) read as None, and ``write_image`` under extensions PIL
      cannot save an L image under raising PIL's exception types;
    - every fixture of ``tests/torch_data/`` decoded and held to the
      digest of PIL's decode (for the 16-bit grey PNG and TIFF, of their
      high bytes), the 2048x2048 progressive JPEG's, YCCK arithmetic
      progressive JPEG's, Deflate TIFF's and lossy WebP's and the
      1024x1024 CMYK arithmetic JPEG's and lossless WebP's decodes timed
      (median of ``decodes``);
    - the reader maps of ``tools/make_torch_fixtures.py`` made here: a
      2048x2048 RGB roughness map as an RLE SGI file (its numpy encoder),
      a 1024x1024 RGB normal map as a PCX file (``write_image``), a
      2048x2048 roughness map as an uncompressed CMYK TIFF and a
      1024x1024 normal map as a PackBits YCbCr TIFF (its numpy TIFF
      encoder), a 1024x1024 normal map as a JPEG-in-TIFF in 256x256
      tiles (each the port's JPEG of its tile, no YCbCrSubsampling tag),
      a 3840x2160 RLE8 BMP under a colour palette, a 256x256 32-bit
      one-entry CUR, a 128x128 ICNS of ``it32`` and ``t8mk`` entries and
      a 512x512 ICNS whose ``ic09`` entry is the port's JP2 file (PIL's
      byte for byte), the ``bc7-bc6h`` session's BC6H and BC7 DDS maps,
      the ``blp-ftex`` session's FTEX and BLP maps, a 512x512 BLP1 JPEG
      normal map (the port's JPEG, split after its SOS segment) and a
      512x512 BLP2 palette roughness map with alpha,
      each file and its decode held to the digests
      recorded with PIL (``tests/torch_data/map_digests.json``), the
      decodes timed; a 2048x2048 P5 at maxval 65535 and a 2048x2048 Pf
      made here, their decodes held to the samples' high bytes (the named
      deviation) and to PIL's ``F`` to ``L`` rule, both timed;
    - ``textured_sphere_scene`` at ``res`` with that JPEG as its roughness
      map and the 1024x1024 baseline JPEG as its normal map, then with the
      YCCK and CMYK arithmetic-coded JPEGs (``jpeg-flavours``), then with
      the TIFF as its roughness map and the 512x512 16-bit LZW TIFF as its
      normal map, then with the two WebPs, then with the RLE SGI and PCX
      maps (``sgi-pcx``), then with the CMYK and YCbCr TIFF maps
      (``tiff-cmyk-ycbcr``), then with the 2048x2048 Group 4 fixture
      ``roughness_2048_g4.tif`` as its roughness map and the JPEG-in-TIFF
      map as its normal map (``tiff-jpeg-ccitt``, both decodes timed),
      then with a 2048x2048 RGB QOI roughness map written by the port and
      a 1024x1024 DXT1 DDS normal map of hashed blocks (``qoi-dds``, both
      decodes timed), then with the port's ICNS of a 2048x2048 RGB
      roughness map, read at its 1024x1024 ``ic10`` entry, and its ICO of
      a 1024x1024 RGB normal map, read at its 256x256 frame (``ico-icns``,
      both decodes timed), then with the port's JP2 file of a 2048x2048
      grey roughness map and its JPEG 2000 codestream of a 1024x1024 RGB
      normal map (``jp2-j2k``, both decodes timed), then with the grey
      channel of ``roughness_map(2048)`` as an RLE8 BMP and
      ``normal_map(256)`` as an ICO of a 24-bit DIB with an AND mask
      (``rle-bmp-ico``, both decodes timed), then with a 2048x2048 BC6H
      UF16 DDS roughness map of bounded hashed blocks over the 14 modes
      and a 1024x1024 BC7 DDS normal map of hashed blocks over the 8
      modes (``bc7-bc6h``, both decodes timed), then with a 2048x2048
      FTEX DXT1 roughness map and a 1024x1024 BLP2 DXT5 normal map with
      the alpha flag, both of hashed blocks (``blp-ftex``, both decodes
      timed), then with the committed PIL files
      ``roughness_2048_97_layers.jp2`` (grey, 9/7, three rate layers) and
      ``normal_1024_97_ict_tiles.j2k`` (RGB, 9/7 and ICT, 256x256 tiles
      at odd offsets, RPCL, 128x128 precincts, two layers) as its maps
      (``j2k-lossy``, both decodes timed, as are the six 19x13 files of
      ``make_torch_fixtures.J2K_OPTION_FILES`` and the ICNS of a 9/7 JP2
      entry), then with the committed PIL files
      ``roughness_2048_zstd.tif`` (grey, ZSTD, predictor 2) and
      ``normal_1024_lzma.tif`` (RGB, LZMA) as its maps
      (``tiff-lzma-zstd``, both decodes timed, as are the two-block ZSTD
      strip ``zstd_blocks_256.tif`` and the LA JPEG TIFF
      ``small_jpeg_la.tif``; Python's ``lzma`` checked first), then with
      the 2048x2048 BITPIX 8 FITS and the 1024x1024 PIXAR of
      ``make_torch_fixtures.RASTER_MAPS`` made here (``fits-pixar``),
      then with the 2048x2048 8-bit run-length Sun raster and the
      1024x1024 RGB XPM of ``make_torch_fixtures.BITMAP_MAPS`` made here
      (``sun-xpm``), then with the 2048x2048 BRUN FLC and the 768x512
      PhotoCD of ``make_torch_fixtures.FLI_PCD_IPTC_MAPS`` made here
      (``fli-pcd``), then with the 2048x2048 predictor-3 float map and
      the 1024x1024 RGB BigTIFF of
      ``make_torch_fixtures.TIFF_FLOAT_BIG_MAPS`` made here
      (``tiff-float-big``), then with the 2048x2048 LZW CIELab TIFF and
      the 1024x1024 RLE CIELab PSD of ``make_torch_fixtures.CIELAB_MAPS``
      made here (``cielab``), through ``"hier"``: the texture table on the
      card bitwise the host decode (alpha included: 0 for the PSD, as
      PIL gives it), ``spp`` samples counted through K3, K2
      and threefry (each drive's ms a sample on the host's clock), then ms
      per sample in turns against the checker-map session (all but
      ``tiff-lzma-zstd``, ``fits-pixar``, ``sun-xpm``, ``fli-pcd``,
      ``tiff-float-big`` and ``cielab``, which only their drives time);
    - the raw-decoder maps of ``make_torch_fixtures.RASTER_MAPS`` made
      here (2048x2048 FITS at BITPIX 8, 16 and -32 and as GZIP_1 tiles,
      a 2-byte McIDAS and a SPIDER file, a 1024x1024 PIXAR and a DCX whose
      first page is the port's 1024x1024 PCX), each file and its decode
      held to ``tests/torch_data/raster_map_digests.json`` (PIL's decode,
      or for the 16-bit maps the high-byte image of the named deviation),
      the decodes timed (median of ``decodes``);
    - the X11 and Sun bitmaps of ``make_torch_fixtures.BITMAP_MAPS`` made
      here (2048x2048 Sun rasters at 8 bits run-length and 24 bits raw
      and a LinS MSP file, 1024x1024 a GIMP brush at depth 4, an XBM, an
      XPM in P mode and one in RGB mode of 2-character keys), each file
      and its decode held to ``tests/torch_data/bitmap_map_digests.json``
      (PIL's decode), the decodes timed (median of ``decodes``);
    - the FLI/FLC, PhotoCD and IPTC files of
      ``make_torch_fixtures.FLI_PCD_IPTC_MAPS`` made here (a 2048x2048
      FLC whose first frame is BRUN under a 256-entry colour chunk, a
      2048x2048 FLI of LC and SS2 chunks, 768x512 PhotoCDs at orientations
      0 and 1, a 2048x2048 raw IPTC band of an RGB record, a 1024x1024 IPTC
      record of the port's baseline JPEG), each file and its decode held
      to ``tests/torch_data/fli_pcd_iptc_map_digests.json`` (PIL's
      decode), the decodes timed (median of ``decodes``);
    - the TIFFs of ``make_torch_fixtures.TIFF_FLOAT_BIG_MAPS`` made here
      (2048x2048 float maps under the floating-point predictor with Adobe
      Deflate in 64-row strips and with ZSTD stored blocks, and as an
      uncompressed BigTIFF; a 1024x1024 RGB BigTIFF under Deflate with
      LONG8 offsets; 2048x2048 12-bit grey maps, uncompressed and under
      LZW; a 1024x1024 uncompressed map of separate 16-bit RGB planes),
      each file and its decode held to
      ``tests/torch_data/tiff_float_big_map_digests.json`` (PIL's decode,
      or for the 12-bit maps the top-8-bit image of the named deviation),
      the decodes timed (median of ``decodes``);
    - LittleCMS's Lab to sRGB table built here (timed) and held to the
      digest of lcms's own table, and the CIELab maps of
      ``make_torch_fixtures.CIELAB_MAPS`` (a 2048x2048 TIFF under LZW with
      predictor 2 in 64-row strips, a 1024x1024 RLE PSD, a 2048x2048
      uncompressed BigTIFF in 256x256 tiles, all made here, and PIL's
      committed 2048x2048 JPEG TIFF), each file and its decode held to
      ``tests/torch_data/cielab_map_digests.json`` (PIL's decode), the
      decodes and the conversion alone of a 2048x2048 map's samples timed
      (median of ``decodes``);
    - ``write_image`` of the 37x29 fixture image and a procedural
      3840x2160 one, as L and RGB, under every extension written byte for
      byte, each file held to the digest of PIL's
      (``tests/torch_data/write_digests.json``; QOI as L raising PIL's
      ``ValueError``; PDFs under ``make_torch_fixtures.pinned_gmtime``;
      ICO and ICNS files by their ``icon_digest``, the frames decoded by
      the port), the DIB, IM, SGI, PCX, QOI, DDS and JPEG 2000 files
      (``READ_BACK``; a file equal to one read back before is not read
      again) read back by the port equal to the pixels, the MPO
      (``READ_BACK_AS_JPEG``) equal to the JPEG's decode, the ICO and ICNS
      (``READ_BACK_AS_FRAME``) equal to the frame PIL's reader picks; the
      4K RGB PCX, SGI and JPEG 2000 decodes and the 4K JPEG, GIF, WebP,
      QOI, DDS, PDF, ICO, ICNS and JPEG 2000 encodes timed (median of
      ``decodes``); ``python
      -m
      pathtracing_spectrum_tpu_torch preview ... --out v.jpg --device
      cuda`` read back by the port's JPEG decoder, ``--out v.gif`` read
      back by its GIF decoder, equal to the preview's grey image, and
      ``--out v.webp`` read back by its WebP decoder, its PSNR against
      the grey image at least ``WEBP_PREVIEW_MIN_PSNR``;
    - the terrains parsed by the native parser and by the plain Python
      one, bitwise equal, both timed; the first rendered through
      ``"hier"`` (``terrain_spp`` samples, counted);
    - a ``export_res``-square crop of the 4K session's result exported
      through the native writer and held byte for byte to
      ``format_spectrum`` (both timed), then the whole 4K result exported
      and timed; the Python writer's 4K time is reckoned from the crop's
      rate rather than run.

    Returns the launches of each kernel over the driven sessions."""
    from pathtracing_spectrum_tpu_torch.utils import (cielab, gif, image,
                                                      jpeg, jpeg2000,
                                                      obj_loader, scene_io,
                                                      spectral_io, webp)
    from pathtracing_spectrum_tpu_torch.preview import preview_render
    # TIFF compression 34925 reads through Python's lzma (liblzma): a
    # Python built without it fails here
    import lzma
    xz = lzma.compress(b"pathtracing" * 100, format=lzma.FORMAT_XZ,
                       check=lzma.CHECK_NONE)
    back = lzma.LZMADecompressor(format=lzma.FORMAT_XZ).decompress(xz, 1100)
    say("files", lzma_module=lzma.__file__, xz_round_trip=back == (
        b"pathtracing" * 100))
    check(back == b"pathtracing" * 100, "the lzma module does not round-trip")
    # files that are no image give None; the extensions PIL cannot save
    # an L or RGB image under raise PIL's exception, writing nothing
    with tempfile.TemporaryDirectory() as tmp:
        none = {}
        for name, data in (("page.png", b"<!DOCTYPE html>\n<html></html>\n"),
                           ("zeros.png", bytes(64)),
                           ("noise.jpg", np.random.default_rng(1).integers(
                               0, 256, 4096, np.uint8).tobytes()),
                           ("sound.webp", b"RIFF" + bytes(4) + b"WAVEfmt ")):
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                f.write(data)
            none[name] = image.load_rgba(path) is None
        raised = {}
        grey = np.zeros((2, 3), np.uint8)
        for ext, want in ((".psd", KeyError), (".xpm", KeyError),
                          (".bufr", OSError), (".msp", OSError),
                          (".blp", ValueError), (".qoi", ValueError),
                          (".avif", NotImplementedError)):
            path = os.path.join(tmp, "out" + ext)
            try:
                image.write_image(path, grey)
                got = None
            except Exception as e:  # noqa: BLE001 (the type is the check)
                got = type(e)
            raised[ext] = got is want and not os.path.exists(path)
        say("files", not_images_none=json.dumps(none),
            write_raises_pils=json.dumps(raised))
        check(all(none.values()), f"a file that is no image: {none}")
        check(all(raised.values()), f"write refusals: {raised}")
    with open(os.path.join(FILES_DIR, "digests.json")) as f:
        digests = json.load(f)
    for name, want in sorted(digests.items()):
        rgba = image.load_rgba8(os.path.join(FILES_DIR, name))
        same = (list(rgba.shape) == want["shape"] and hashlib.sha256(
            rgba.tobytes()).hexdigest() == want["rgba_sha256"])
        say("files", fixture=name, shape=list(rgba.shape),
            digest_of=want["of"], digest_equal=same)
        check(same, f"{name}: the decode is not its recorded digest")
    def median_ms(fn, runs=decodes):
        secs = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        return [1e3 * t for t in secs], 1e3 * sorted(secs)[len(secs) // 2]

    # the RLE SGI and PCX maps, made here and held to PIL's digests
    fixtures = load_by_path("make_torch_fixtures", os.path.join(
        HERE, "tools", "make_torch_fixtures.py"))
    with open(os.path.join(FILES_DIR, "map_digests.json")) as f:
        map_digests = json.load(f)
    check(sorted(map_digests) == sorted(fixtures.READER_MAPS),
          "map_digests.json names other maps than READER_MAPS")
    maps_dir = tempfile.TemporaryDirectory()
    for name, want in sorted(map_digests.items()):
        px, data = fixtures.reader_map(
            name, lambda px: jpeg2000.encode(px, "jp2"), jpg=jpeg.encode)
        path = os.path.join(maps_dir.name, name)
        if data is None:
            image.write_image(path, px)
        else:
            with open(path, "wb") as f:
                f.write(data)
        with open(path, "rb") as f:
            file_same = fixtures.file_digest(
                name, f.read(), image._decode_png) == want["file_sha256"]
        rgba = image.load_rgba8(path)
        same = (list(rgba.shape) == want["shape"] and hashlib.sha256(
            rgba.tobytes()).hexdigest() == want["rgba_sha256"])
        say("files", reader_map=name, bytes=os.path.getsize(path),
            file_digest_equal=file_same, shape=list(rgba.shape),
            digest_of=want["of"], digest_equal=same)
        check(file_same, f"{name}: the file is not the one PIL decoded")
        check(same, f"{name}: the decode is not its recorded digest")

    # the raw-decoder maps (FITS, McIDAS, SPIDER, PIXAR, DCX), made here
    # and held to the digests recorded with PIL, their decodes timed
    with open(os.path.join(FILES_DIR, "raster_map_digests.json")) as f:
        raster_digests = json.load(f)
    check(sorted(raster_digests) == sorted(fixtures.RASTER_MAPS),
          "raster_map_digests.json names other maps than RASTER_MAPS")

    def pcx(px):
        page = os.path.join(maps_dir.name, "page.pcx")
        image.write_image(page, px)
        with open(page, "rb") as f:
            return f.read()

    for name, want in sorted(raster_digests.items()):
        data, _ = fixtures.raster_map(name, pcx=pcx)
        path = os.path.join(maps_dir.name, name)
        with open(path, "wb") as f:
            f.write(data)
        file_same = hashlib.sha256(data).hexdigest() == want["file_sha256"]
        rgba = image.load_rgba8(path)
        same = (list(rgba.shape) == want["shape"] and hashlib.sha256(
            rgba.tobytes()).hexdigest() == want["rgba_sha256"])
        ms, med = median_ms(lambda: image.load_rgba8(path))
        say("files", raster_map=name, bytes=len(data),
            file_digest_equal=file_same, shape=list(rgba.shape),
            digest_of=want["of"], digest_equal=same, runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
        check(file_same, f"{name}: the file is not the one PIL decoded")
        check(same, f"{name}: the decode is not its recorded digest")

    # the X11 and Sun bitmaps (SUN, GBR, MSP, XBM, XPM) and the FLI/FLC,
    # PhotoCD and IPTC files (the IPTC JPEG by the port's encoder, PIL's
    # file byte for byte), made here and held to the digests recorded with
    # PIL, their decodes timed
    for kind, names, make in (
            ("bitmap_map", fixtures.BITMAP_MAPS, fixtures.bitmap_map),
            ("fli_pcd_iptc_map", fixtures.FLI_PCD_IPTC_MAPS,
             lambda name: fixtures.fli_pcd_iptc_map(name, jpg=jpeg.encode)),
            ("tiff_float_big_map", fixtures.TIFF_FLOAT_BIG_MAPS,
             lambda name: fixtures.tiff_float_big_map(name)[0])):
        with open(os.path.join(FILES_DIR, f"{kind}_digests.json")) as f:
            map_digests = json.load(f)
        check(sorted(map_digests) == sorted(names),
              f"{kind}_digests.json names other maps than its builder's")
        for name, want in sorted(map_digests.items()):
            data = make(name)
            path = os.path.join(maps_dir.name, name)
            with open(path, "wb") as f:
                f.write(data)
            file_same = (hashlib.sha256(data).hexdigest()
                         == want["file_sha256"])
            rgba = image.load_rgba8(path)
            same = (list(rgba.shape) == want["shape"] and hashlib.sha256(
                rgba.tobytes()).hexdigest() == want["rgba_sha256"])
            ms, med = median_ms(lambda: image.load_rgba8(path))
            say("files", **{kind: name}, bytes=len(data),
                file_digest_equal=file_same, shape=list(rgba.shape),
                digest_of=want["of"], digest_equal=same, runs=decodes,
                ms=ms, median_ms=med, clock="host", card=repr(card))
            check(file_same, f"{name}: the file is not the one PIL decoded")
            check(same, f"{name}: the decode is not its recorded digest")

    # CIELab: LittleCMS's table built here and held to the digest of
    # lcms's own (recorded with PIL's library), the maps made here (the
    # JPEG one committed) held to PIL's digests and their decodes timed,
    # then the conversion alone on the 2048x2048 map's samples
    with open(os.path.join(FILES_DIR, "cielab_map_digests.json")) as f:
        lab_digests = json.load(f)
    cielab.table.cache_clear()
    t0 = time.perf_counter()
    table_same = cielab.table_digest() == lab_digests["table"]["sha256"]
    say("files", cielab_table=lab_digests["table"]["shape"],
        digest_of=lab_digests["table"]["of"], digest_equal=table_same,
        build_ms=1e3 * (time.perf_counter() - t0), clock="host",
        card=repr(card))
    check(table_same, "the Lab to sRGB table is not LittleCMS's")
    check(sorted(lab_digests["maps"]) == sorted(fixtures.CIELAB_MAPS),
          "cielab_map_digests.json names other maps than CIELAB_MAPS")
    for name, want in sorted(lab_digests["maps"].items()):
        data = fixtures.cielab_map(name)
        path = os.path.join(maps_dir.name, name)
        with open(path, "wb") as f:
            f.write(data)
        file_same = hashlib.sha256(data).hexdigest() == want["file_sha256"]
        rgba = image.load_rgba8(path)
        same = (list(rgba.shape) == want["shape"] and hashlib.sha256(
            rgba.tobytes()).hexdigest() == want["rgba_sha256"])
        ms, med = median_ms(lambda: image.load_rgba8(path))
        say("files", cielab_map=name, bytes=len(data),
            file_digest_equal=file_same, shape=list(rgba.shape),
            digest_of=want["of"], digest_equal=same, runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
        check(file_same, f"{name}: the file is not the one PIL decoded")
        check(same, f"{name}: the decode is not its recorded digest")
    lab = fixtures.roughness_map(2048) ^ np.array([0, 128, 128], np.uint8)
    ms, med = median_ms(lambda: cielab.lab_rgba(lab, 255))
    say("files", cielab_conversion=list(lab.shape), route="host C++",
        runs=decodes, ms=ms, median_ms=med, clock="host", card=repr(card))

    maps = {"jpeg": ("roughness_2048_prog420.jpg", "normal_1024_444.jpg"),
            "jpeg-flavours": ("roughness_2048_ycck_arith_prog.jpg",
                              "normal_1024_cmyk_arith.jpg"),
            "tiff": ("roughness_2048_deflate.tif", "normal_512_lzw16.tif"),
            "webp": ("roughness_2048_lossy.webp", "normal_1024_lossless.webp"),
            "sgi-pcx": tuple(os.path.join(maps_dir.name, name) for name in (
                "roughness_2048_rle.sgi", "normal_1024.pcx")),
            "tiff-cmyk-ycbcr": tuple(os.path.join(maps_dir.name, name)
                                     for name in (
                "roughness_2048_cmyk.tif", "normal_1024_ycbcr_packbits.tif")),
            "tiff-jpeg-ccitt": ("roughness_2048_g4.tif", os.path.join(
                maps_dir.name, "normal_1024_jpeg_tiles.tif")),
            "qoi-dds": tuple(os.path.join(maps_dir.name, name) for name in (
                "roughness_2048.qoi", "normal_1024_dxt1.dds")),
            "ico-icns": tuple(os.path.join(maps_dir.name, name) for name in (
                "roughness_2048.icns", "normal_1024.ico")),
            "jp2-j2k": tuple(os.path.join(maps_dir.name, name) for name in (
                "roughness_2048_grey.jp2", "normal_1024.j2k")),
            "rle-bmp-ico": tuple(os.path.join(maps_dir.name, name)
                                 for name in ("roughness_2048_rle8.bmp",
                                              "normal_256_dib.ico")),
            "bc7-bc6h": tuple(os.path.join(maps_dir.name, name)
                              for name in ("roughness_2048_bc6h.dds",
                                           "normal_1024_bc7.dds")),
            "blp-ftex": tuple(os.path.join(maps_dir.name, name)
                              for name in ("roughness_2048_dxt1.ftc",
                                           "normal_1024_dxt5.blp")),
            "j2k-lossy": ("roughness_2048_97_layers.jp2",
                          "normal_1024_97_ict_tiles.j2k"),
            "tiff-lzma-zstd": ("roughness_2048_zstd.tif",
                               "normal_1024_lzma.tif"),
            "fits-pixar": tuple(os.path.join(maps_dir.name, name)
                                for name in ("roughness_2048.fits",
                                             "normal_1024.pxr")),
            "sun-xpm": tuple(os.path.join(maps_dir.name, name)
                             for name in ("roughness_2048_rle.ras",
                                          "normal_1024.xpm")),
            "fli-pcd": tuple(os.path.join(maps_dir.name, name)
                             for name in ("roughness_2048_brun.flc",
                                          "normal_768x512.pcd")),
            "tiff-float-big": tuple(os.path.join(maps_dir.name, name)
                                    for name in ("roughness_2048_pred3.tif",
                                                 "normal_1024_big.tif")),
            "cielab": tuple(os.path.join(maps_dir.name, name)
                            for name in ("roughness_2048_lab_lzw.tif",
                                         "normal_1024_lab_rle.psd"))}
    for name in [rough for rough, _ in maps.values()] + [
            maps["jpeg-flavours"][1], maps["webp"][1], maps["sgi-pcx"][1],
            maps["tiff-cmyk-ycbcr"][1], maps["tiff-jpeg-ccitt"][1],
            maps["qoi-dds"][1], maps["ico-icns"][1], maps["jp2-j2k"][1],
            maps["rle-bmp-ico"][1], maps["bc7-bc6h"][1],
            maps["blp-ftex"][1], maps["j2k-lossy"][1],
            maps["tiff-lzma-zstd"][1], "zstd_blocks_256.tif",
            "small_jpeg_la.tif"] + [
                os.path.join(maps_dir.name, name) for name in (
                    "rle8_3840x2160.bmp", "cursor_256.cur",
                    "icon_128_it32.icns", "icon_512_jp2.icns",
                    "normal_512_jpeg.blp", "roughness_512_palette.blp")] + [
                name for name in fixtures.J2K_OPTION_FILES
                if not name.startswith(("roughness_", "normal_"))]:
        path = os.path.join(FILES_DIR, name)
        ms, med = median_ms(lambda: image.load_rgba8(path))
        say("files", decode=os.path.basename(name), runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
    # a 16-bit P5 and a Pf made here: the P5 keeps its samples' high bytes
    # (the named deviation), the Pf is PIL's F to L (truncated, clipped)
    grey = fixtures.procedural_rgb(2048, 2048, 15).astype(np.int64)
    wide = grey[..., 0] * 256 + grey[..., 1]
    flt = grey[..., 2].astype(np.float32) * np.float32(1.25) - np.float32(
        30.5)
    for name, data, want in (
            ("grey16_2048.pgm", b"P5\n2048 2048\n65535\n"
             + wide.astype(">u2").tobytes(), grey[..., 0]),
            ("float_2048.pfm", b"Pf\n2048 2048\n-1.0\n"
             + flt[::-1].astype("<f4").tobytes(),
             np.clip(flt, 0, 255).astype(np.int64))):
        path = os.path.join(maps_dir.name, name)
        with open(path, "wb") as f:
            f.write(data)
        rgba = image.load_rgba8(path)
        same = (rgba.shape == (2048, 2048, 4) and np.array_equal(
            rgba[..., 0], want) and bool((rgba[..., 3] == 255).all()))
        ms, med = median_ms(lambda: image.load_rgba8(path))
        say("files", decode=name, equals_samples=same, runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
        check(same, f"{name}: the decode is not its samples' rule")

    # the textured sessions with the JPEG maps, the arithmetic-coded YCCK
    # and CMYK JPEG maps, the TIFF maps (16-bit LZW normals), the WebP
    # maps (lossy roughness, lossless normals with alpha), the SGI and PCX
    # maps, the CMYK and YCbCr TIFF maps, the Group 4 and JPEG-in-TIFF
    # maps, the QOI and DXT1 maps, the ICNS and ICO maps, the JP2 and
    # JPEG 2000 codestream maps, the RLE8 BMP and DIB-framed ICO maps and
    # the BC6H and BC7 DDS maps and the FTEX and BLP maps and the lossy
    # JPEG 2000 maps and the ZSTD and LZMA TIFF maps and the FITS and PIXAR
    # maps and the run-length SUN and RGB XPM maps and the BRUN FLC and
    # PhotoCD maps and the predictor-3 and BigTIFF maps and the CIELab
    # TIFF and PSD maps, each counted through K3, K2 and threefry
    launches = {}
    sessions = {}
    for kind, (rough, normal) in maps.items():
        rough = os.path.join(FILES_DIR, rough)
        normal = os.path.join(FILES_DIR, normal)
        sc_m = textured_sphere_scene(pt, res, roughness=rough, normal=normal)
        data_m = sc_m.compile(dev)
        table = data_m.textures
        # padded to the larger map: 2048² (1024² for the ICNS and ICO maps)
        side = 1024 if kind == "ico-icns" else 2048
        same = tuple(table.shape) == (2, side, side, 4)
        for i, path in enumerate((normal, rough)):  # normal maps come first
            host = torch.from_numpy(image.load_rgba(path))
            h, w = host.shape[:2]
            same = same and torch.equal(table[i, :h, :w].cpu(), host)
        say("files", maps=kind, texture_table=list(table.shape),
            table_equals_host_decode=same)
        check(same, f"{kind} maps: the texture table on the card is not "
              "the host decode")
        del data_m, table
        warm = pt.RenderSession(sc_m, dev, seed=1)
        warm.run(1, batch=1)
        del warm
        sess_m = pt.RenderSession(sc_m, dev, seed=0)
        t0 = time.perf_counter()
        img_m, got = drive(torch, sess_m, spp, counts, zero_counts)
        drive_ms = 1e3 * (time.perf_counter() - t0) / spp
        st = sess_m.stats()
        want = want_counts(spp, DEPTH, route="intersect_bvh", sorts=spp)
        say("files", session=f"textured-{kind} {res[0]}x{res[1]}", spp=spp,
            backend=st["backend"], launches=json.dumps(got),
            expected=json.dumps(want), mean=float(img_m.mean()),
            drive_ms_per_sample=drive_ms, clock="host", card=repr(card))
        check(st["backend"] == "hier", f"textured-{kind} resolved "
              f"{st['backend']}")
        check(got == want, f"textured-{kind} launches {got}, expected {want}")
        check(img_m.shape == (res[1], res[0], 4), f"image shape {img_m.shape}")
        healthy(img_m, f"textured-{kind}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        if kind not in ("tiff-lzma-zstd", "fits-pixar", "sun-xpm",
                        "fli-pcd", "tiff-float-big", "cielab"):
            sessions[kind] = sess_m   # (the others timed by their drives)
        del img_m, sess_m
    sessions["checker"] = pt.RenderSession(textured_sphere_scene(pt, res),
                                           dev, seed=0)
    sessions["checker"].run(1, batch=1)
    turns = ("checker", "jpeg", "jpeg-flavours", "tiff", "webp", "sgi-pcx",
             "tiff-cmyk-ycbcr", "tiff-jpeg-ccitt", "qoi-dds", "ico-icns",
             "jp2-j2k", "rle-bmp-ico", "bc7-bc6h", "blp-ftex", "j2k-lossy",
             "j2k-lossy", "blp-ftex", "bc7-bc6h", "rle-bmp-ico",
             "jp2-j2k", "ico-icns",
             "qoi-dds", "tiff-jpeg-ccitt",
             "tiff-cmyk-ycbcr", "sgi-pcx", "webp", "tiff", "jpeg-flavours",
             "jpeg", "checker")
    rates = {name: [] for name in turns}
    for name in turns:
        rates[name].append(timed_step(torch, sessions[name], rate_spp))
    for name, vals in rates.items():
        say("files", session=f"textured-{name}", spp_per_step=rate_spp,
            mrays_per_s=[v[0] for v in vals],
            ms_per_sample=[v[1] for v in vals], card=repr(card))
    del sessions
    maps_dir.cleanup()

    # the writers: two images as L and RGB under every extension written
    # byte for byte, held to the digests of PIL's files (QOI as L to PIL's
    # ValueError, PDFs at a pinned time, ICO and ICNS frame for frame); the
    # 4K JPEG, GIF, WebP, QOI, DDS, PDF, ICO, ICNS and JPEG 2000 encodes
    # and the 4K JPEG 2000 decode timed; a preview written as a JPEG, a
    # GIF and a WebP by the module's CLI
    with open(os.path.join(FILES_DIR, "write_digests.json")) as f:
        write_digests = json.load(f)
    images = fixtures.writer_images()
    check(sorted(images) == sorted(write_digests), "write_digests.json "
          "names other images than make_torch_fixtures.writer_images")
    with tempfile.TemporaryDirectory() as tmp:
        for name, modes in sorted(images.items()):
            for mode, px in sorted(modes.items()):
                wanted = write_digests[name][mode]
                same, back = [], []
                # a read-back per distinct file: the JP2 names' files are
                # one file, read once
                read = {}
                rgba = np.full(px.shape[:2] + (4,), 255, np.uint8)
                rgba[..., :3] = px[..., None] if px.ndim == 2 else px
                jpeg_rgba = None
                for ext in fixtures.WRITE_EXTENSIONS:
                    path = os.path.join(tmp, "x" + ext)
                    if wanted[ext] == fixtures.QOI_L_RAISES:
                        try:
                            image.write_image(path, px)
                            raised = None
                        except ValueError as e:
                            raised = f"ValueError: {e}"
                        same.append(raised == wanted[ext]
                                    and not os.path.exists(path))
                        continue
                    with fixtures.pinned_gmtime():
                        image.write_image(path, px)
                    with open(path, "rb") as f:
                        data = f.read()
                    same.append(fixtures.file_digest(
                        ext, data, image._decode_png) == wanted[ext])
                    if ext == ".jpg":
                        jpeg_rgba = image.load_rgba8(path)
                    if ext in READ_BACK:
                        key = hashlib.sha256(data).digest()
                        if key not in read:
                            read[key] = np.array_equal(
                                image.load_rgba8(path), rgba)
                        back.append(read[key])
                    if ext in READ_BACK_AS_JPEG:
                        back.append(np.array_equal(image.load_rgba8(path),
                                                   jpeg_rgba))
                    if ext in READ_BACK_AS_FRAME:
                        back.append(np.array_equal(
                            image.load_rgba8(path),
                            image._decode_png(picked_frame(data))))
                    os.remove(path)
                n_back = len([e for e in READ_BACK + READ_BACK_AS_JPEG
                              + READ_BACK_AS_FRAME
                              if wanted[e] != fixtures.QOI_L_RAISES])
                say("files", write=name, mode=mode,
                    extensions=len(same), digests_equal=sum(same),
                    read_back=len(back), read_back_equal=sum(back))
                check(all(same), f"{name} {mode}: a written file is not "
                      "PIL's")
                check(len(back) == n_back and all(back),
                      f"{name} {mode}: a DIB, IM, SGI, PCX, QOI, DDS, JPEG "
                      "2000, MPO, ICO or ICNS file the port wrote does not "
                      "read back as its pixels")
        rgb4k = images["procedural_3840x2160"]["RGB"]
        for ext in (".pcx", ".sgi"):
            path = os.path.join(tmp, "x" + ext)
            image.write_image(path, rgb4k)
            ms, med = median_ms(lambda: image.load_rgba8(path))
            say("files", decode=f"x{ext} 3840x2160 RGB", runs=decodes, ms=ms,
                median_ms=med, clock="host", card=repr(card))
            os.remove(path)
        ms, med = median_ms(lambda: jpeg.encode(rgb4k))
        say("files", jpeg_encode="3840x2160 RGB", runs=decodes, ms=ms,
            median_ms=med, clock="host")
        ms, med = median_ms(lambda: gif.encode(rgb4k))
        say("files", gif_encode="3840x2160 RGB", runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
        ms, med = median_ms(lambda: webp.encode(rgb4k))
        say("files", webp_encode="3840x2160 RGB", runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
        ms, med = median_ms(lambda: jpeg2000.encode(rgb4k, "jp2"))
        say("files", jpeg2000_encode="3840x2160 RGB", runs=decodes, ms=ms,
            median_ms=med, clock="host", card=repr(card))
        path = os.path.join(tmp, "x.jp2")
        image.write_image(path, rgb4k)
        ms, med = median_ms(lambda: image.load_rgba8(path))
        say("files", decode="x.jp2 3840x2160 RGB", bytes=os.path.getsize(path),
            runs=decodes, ms=ms, median_ms=med, clock="host", card=repr(card))
        os.remove(path)
        for fmt, encode in (("qoi", image._qoi_bytes),
                            ("dds", image._dds_bytes),
                            ("pdf", lambda px: image._pdf_bytes(px, "x.pdf")),
                            ("ico", image._ico_bytes),
                            ("icns", image._icns_bytes)):
            ms, med = median_ms(lambda: encode(rgb4k))
            say("files", **{f"{fmt}_encode": "3840x2160 RGB"}, runs=decodes,
                ms=ms, median_ms=med, clock="host", card=repr(card))
        scene_path = os.path.join(tmp, "textured.pts")
        out = os.path.join(tmp, "v.jpg")
        scene_io.save_scene(textured_sphere_scene(
            pt, (640, 360), roughness=os.path.join(
                FILES_DIR, "roughness_2048_deflate.tif")), scene_path)
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "preview", scene_path, "--out", out,
             "--device", "cuda"], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        head = b""
        if proc.returncode == 0:
            with open(out, "rb") as f:
                head = f.read(3)
        view = image.load_rgba8(out) if head == b"\xff\xd8\xff" else None
        say("files", module_preview="v.jpg", rc=proc.returncode,
            jpeg=head == b"\xff\xd8\xff",
            shape=None if view is None else list(view.shape))
        check(proc.returncode == 0, f"module preview failed: {proc.stderr}")
        check(view is not None and view.shape == (360, 640, 4)
              and view[..., :3].max() > 0,
              "the module's preview is not a JPEG the port decodes")
        # as a GIF: 256 grey levels or fewer, so the file is lossless
        out = os.path.join(tmp, "v.gif")
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "preview", scene_path, "--out", out,
             "--device", "cuda"], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, f"module GIF preview failed: "
              f"{proc.stderr}")
        with open(out, "rb") as f:
            data = f.read()
        view = image._decode_gif(data)
        grey = preview_render(scene_io.load_scene(scene_path), 640, 360,
                              device=dev)
        same = view.shape == (360, 640, 4) and bool(
            (view[..., :3] == grey[..., None]).all()
            and (view[..., 3] == 255).all())
        say("files", module_preview="v.gif", rc=proc.returncode,
            gif=data[:6] == b"GIF87a", shape=list(view.shape),
            equals_preview_render=same, grey_levels=len(np.unique(grey)))
        check(same, "the module's GIF preview does not decode to the "
              "preview's grey image")
        # as a WebP: lossy, so held to the grey image by its PSNR
        out = os.path.join(tmp, "v.webp")
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "preview", scene_path, "--out", out,
             "--device", "cuda"], cwd=HERE, capture_output=True, text=True,
            timeout=300)
        check(proc.returncode == 0, f"module WebP preview failed: "
              f"{proc.stderr}")
        with open(out, "rb") as f:
            data = f.read()
        is_webp = data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8 "
        view = webp.decode_rgba(data) if is_webp else None
        psnr = (preview_psnr(view, grey)
                if view is not None and view.shape == (360, 640, 4) else None)
        say("files", module_preview="v.webp", rc=proc.returncode,
            webp=is_webp, bytes=len(data),
            shape=None if view is None else list(view.shape),
            psnr_db=psnr, min_psnr_db=WEBP_PREVIEW_MIN_PSNR)
        check(psnr is not None and psnr >= WEBP_PREVIEW_MIN_PSNR,
              "the module's WebP preview is not a VP8 file within "
              f"{WEBP_PREVIEW_MIN_PSNR} dB of the preview's grey image")

    # the OBJ parse, native and plain, then the 52k terrain rendered
    paths = {}
    for which in terrains:
        paths[which] = make_terrain(which)
        t0 = time.perf_counter()
        mesh = obj_loader.load_obj(paths[which])
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = obj_loader._load_obj_py(paths[which])
        python_s = time.perf_counter() - t0
        same = all(np.array_equal(getattr(mesh, k).view(np.int32),
                                  getattr(plain, k).view(np.int32))
                   for k in ("vertices", "texcoords", "normals"))
        same = same and [(s.name, s.v_idx.tobytes(), s.vt_idx.tobytes(),
                          s.vn_idx.tobytes(), s.smoothing.tobytes())
                         for s in mesh.shapes] == [
            (s.name, s.v_idx.tobytes(), s.vt_idx.tobytes(),
             s.vn_idx.tobytes(), s.smoothing.tobytes())
            for s in plain.shapes]
        tris = sum(s.v_idx.shape[0] for s in mesh.shapes)
        say("files", obj=f"terrain_{which}", triangles=tris,
            native_s=native_s, python_s=python_s, bitwise_equal=same,
            clock="host")
        check(same, f"terrain_{which}: the native and Python parses differ")
    sc_t = terrain_scene(pt, paths[terrains[0]], terrain_res)
    sess_t = pt.RenderSession(sc_t, dev, seed=0)
    img_t, got = drive(torch, sess_t, terrain_spp, counts, zero_counts)
    st = sess_t.stats()
    want = want_counts(terrain_spp, DEPTH, route="intersect_bvh",
                       sorts=terrain_spp * (2 * DEPTH - 1))
    say("files", session=f"terrain_{terrains[0]} {terrain_res}x{terrain_res}",
        spp=terrain_spp, backend=st["backend"], launches=json.dumps(got),
        expected=json.dumps(want), mean=float(img_t.mean()))
    check(st["backend"] == "hier", f"terrain resolved {st['backend']}")
    check(got == want, f"terrain launches {got}, expected {want}")
    healthy(img_t, f"terrain_{terrains[0]}")
    for k, n in got.items():
        launches[k] += n
    del sess_t, img_t

    # the export: a crop held to the formatter, then the 4K result timed
    result = sess_4k.result()
    crop = np.ascontiguousarray(result[:export_res, :export_res])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "crop.txt")
        t0 = time.perf_counter()
        spectral_io.export_spectrum(path, crop)
        native_crop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        text = spectral_io.format_spectrum(crop)
        python_crop_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            same = f.read() == text.encode()
        del text
        path = os.path.join(tmp, "4k.txt")
        t0 = time.perf_counter()
        spectral_io.export_spectrum(path, result)
        native_4k_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
    h, w, nw = result.shape
    say("files", export=f"{export_res}x{export_res}x{nw}",
        bytes_equal_format_spectrum=same, native_s=native_crop_s,
        python_s=python_crop_s, clock="host")
    say("files", export=f"{w}x{h}x{nw}", values=int(result.size),
        native_s=native_4k_s, mb=mb,
        python_s_reckoned=python_crop_s * result.size / crop.size,
        clock="host")
    check(same, "the native export differs from format_spectrum")
    return launches


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no process listens on."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_replay(torch, pt, sc, data, dev, size, spp, seed):
    """The [H, W, nw] image a sharded session of ``spp`` samples (one
    ``render_samples`` call) on a mesh of ``size`` entries must give,
    rebuilt without the strategy: the session's rays in tile order, padded
    with zero rays to a multiple of ``size``, each tile ``g`` through the
    one-device ``engine.render_samples(fold_device=g)`` on ``dev``, the
    tiles put together, the padding dropped. With ``size`` 1 it is also
    ``SppAllreduce``'s image on a one-device mesh."""
    from pathtracing_spectrum_tpu_torch import engine
    from pathtracing_spectrum_tpu_torch.models.camera import tile_order
    from pathtracing_spectrum_tpu_torch.ops import rng
    w, h = sc.resolution
    nw = data.n_waves
    ro, rd = pt.camera_rays(sc.camera(), w, h, "cpu")
    perm, inv = tile_order(w, h)
    perm_t = torch.from_numpy(perm.astype(np.int64))
    n = w * h
    pad = torch.zeros(((-n) % size, 3))
    ro, rd = torch.cat([ro[perm_t], pad]), torch.cat([rd[perm_t], pad])
    nloc = ro.shape[0] // size
    tiles = []
    for g in range(size):
        s = slice(g * nloc, (g + 1) * nloc)
        total = torch.zeros((nloc, nw), device=dev)
        engine.render_samples(data, ro[s].to(dev), rd[s].to(dev), total, 0,
                              rng.key(seed), 0, n_steps=spp,
                              max_depth=sc.trace_depth, fold_device=g)
        tiles.append(total)
    out = (torch.cat(tiles)[:n] / spp).cpu().numpy()
    return out[inv].reshape(h, w, nw)


def multi_phase(torch, pt, dev, card, counts, zero_counts, sc, sc52,
                spp=MULTI_SPP, terrain_spp=MULTI_TERRAIN_SPP,
                ragged=MULTI_RAGGED, rate_turns=MULTI_RATE_TURNS):
    """Multi-device rendering on the one card. ``TileSharding(make_mesh())``
    runs the main path's box (``sc``, 512², ``spp`` samples); then a mesh of
    ``ragged`` entries of this card cuts its 262,144 rays into tiles of
    87,382, the last with 2 zero-direction padding rays, for the box (K1)
    and the terrain 52k (``sc52``, ``"hier"``: K3 and the reorder); then
    ``SppAllreduce`` on a one-rank NCCL group (the group's all_reduce on
    the card). Each session is driven with the counts set to 0 just
    before and read just after, and its image must be bitwise
    :func:`sharded_replay`'s. K1 or K3, K2 and threefry are held bitwise
    against their plain versions on the padded tile's primaries and
    bounce-2 rays and at its [4, 87,382] draw. Then ms per sample of the
    unsharded, the one-device and the ragged session in turns. Returns
    (the launches of each kernel over the driven runs, the largest error
    of each kernel held)."""
    import torch.distributed as dist
    from pathtracing_spectrum_tpu_torch import engine
    from pathtracing_spectrum_tpu_torch.ops import (
        fetch_cuda, intersect_cuda, intersect_hier_cuda, rng, rng_cuda)
    from pathtracing_spectrum_tpu_torch.parallel import (
        SppAllreduce, TileSharding, make_mesh)
    launches, errs, sessions = {}, {}, {}

    def driven(label, scene, sharding, n, route="intersect_dense", sorts=0):
        sess = pt.RenderSession(scene, seed=0, sharding=sharding)
        img, got = drive(torch, sess, n, counts, zero_counts)
        size = sharding.mesh.size
        want = {k: v * (size if sharding.name == "tiles" else 1)
                for k, v in want_counts(n, DEPTH, route=route,
                                        sorts=sorts).items()}
        replay = sharded_replay(torch, pt, scene, sess._scene_data, dev,
                                size if sharding.name == "tiles" else 1, n,
                                0)
        same = np.array_equal(img, replay)
        st = sess.stats()
        w, h = scene.resolution
        say("multi", case=label, strategy=sharding.name, mesh_size=size,
            distributed=sharding.mesh.distributed, res=f"{w}x{h}", spp=n,
            padding_rays=(-(w * h)) % size if sharding.name == "tiles" else 0,
            backend=st["backend"], launches=json.dumps(got),
            expected=json.dumps(want), rays_traced=st["rays_traced"],
            bitwise_equal_replay=same,
            max_abs_diff=float(np.abs(img - replay).max()),
            mean=float(img.mean()))
        check(got == want, f"multi {label} launches {got}, expected {want}")
        check(same, f"multi {label}: the image is not bitwise its replay")
        healthy(img, f"multi {label}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        sessions[label] = sess
        return sess

    def held(label, case, got, want, kname):
        errs[kname] = max(errs.get(kname, 0.0), hold(label, case, got, want))

    mesh1 = make_mesh()
    mesh3 = make_mesh([str(dev)] * ragged)
    driven("cornell-card", sc, TileSharding(mesh1), spp)
    box3 = driven(f"cornell-{ragged}", sc, TileSharding(mesh3), spp)
    t3 = driven(f"terrain-{ragged}", sc52, TileSharding(mesh3), terrain_spp,
                route="intersect_bvh", sorts=terrain_spp * (2 * DEPTH - 1))
    check(t3.stats()["backend"] == "hier", "the sharded terrain is not hier")

    # the kernels at the padded tile's shapes: its last 2 rays are zero
    for sess, label in ((box3, "K1"), (t3, "K3")):
        data = sess._scene_data
        ro_t, rd_t = sess._ro[-1], sess._rd[-1]
        nloc = ro_t.shape[0]
        check(not ro_t[-2:].any() and not rd_t[-2:].any(),
              "the last tile does not end in 2 zero rays")
        tri16 = tri16_of(data)
        if label == "K1":
            def kernel(planes):
                return intersect_cuda.intersect_dense(*planes, tri16)

            def plain(planes):
                return intersect_cuda.intersect_dense_ref(*planes, tri16)
            kname = "intersect_dense"
        else:
            _, nodes, packed = hier_tables(data)

            def kernel(planes):
                return intersect_hier_cuda.intersect_bvh(*planes, tri16,
                                                         packed)

            def plain(planes):
                return intersect_hier_cuda.intersect_bvh_ref(*planes, tri16,
                                                             *nodes)
            kname = "intersect_bvh"
        prim = planes_of(ro_t, rd_t)
        hit = kernel(prim)
        held(label, "padded-tile-primaries", hit, plain(prim), kname)
        check(not hit[0][-2:].any(), "a zero-direction padding ray hit")
        shade = engine._prepare(data, "auto").shade_sub
        held("K2", "padded-tile-primaries", fetch_cuda.fetch_rows(hit[2],
                                                                  shade),
             fetch_cuda.fetch_rows_ref(hit[2], shade), "fetch_rows")
        bounce = rays_of_bounce(data, ro_t, rd_t, 2)
        held(label, "padded-tile-bounce2", kernel(bounce), plain(bounce),
             kname)
        k = rng.fold_in(rng.fold_in(rng.key(0), 0), ragged - 1)
        held("rng", "padded-tile", rng_cuda.uniform(k, (4, nloc), dev),
             rng.uniform_ref(k, (4, nloc), dev), "threefry_uniform")
        del hit, prim, bounce

    # spp-allreduce through NCCL: a group of this one process, brought up
    # here with initialize_multihost's own arguments (initialize_multihost
    # is a no-op for one process, as in the JAX package)
    check(dist.is_nccl_available(), "torch has no NCCL")
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh_nccl = make_mesh()
        check(mesh_nccl.distributed, "the mesh did not see the NCCL group")
        driven("cornell-nccl", sc, SppAllreduce(mesh_nccl), spp)
    finally:
        dist.destroy_process_group()

    # ms per sample: unsharded, the card's mesh, the ragged mesh, in turns
    plain_sess = pt.RenderSession(sc, dev, seed=0)
    plain_sess.run(1, batch=1)
    rates = {"unsharded": [], "cornell-card": [], f"cornell-{ragged}": []}
    order = list(rates) + list(rates)[::-1]
    for name in order * rate_turns:
        sess = plain_sess if name == "unsharded" else sessions[name]
        rates[name].append(timed_step(torch, sess, spp))
    for name, vals in rates.items():
        say("multi", case=name, spp_per_step=spp,
            mrays_per_s=[v[0] for v in vals],
            ms_per_sample=[v[1] for v in vals], card=repr(card))
    return launches, errs


def shell_phase(torch, pt, dev, card, counts, zero_counts, sc,
                spp=SHELL_SPP):
    """A scripted shell session on the card (``SpectrumShell`` on ``dev``):
    open the main path's box from a ``.pts``, ``render`` ``spp`` samples on
    the async loop (one ``step(1)`` a sample: ``spp * 6`` launches of K1,
    K2 and threefry), ``status``, ``export``, ``preview``, ``autopreview
    on`` and a ``select`` (one K1 launch each), ``quit``; the counts set to
    0 just before and read just after. The export is the session's image
    and the preview PNG ``preview_render``'s. Returns the launches."""
    import io
    from pathtracing_spectrum_tpu_torch import preview
    from pathtracing_spectrum_tpu_torch.render import RenderStatus
    from pathtracing_spectrum_tpu_torch.shell import SpectrumShell
    from pathtracing_spectrum_tpu_torch.utils import scene_io, spectral_io
    from pathtracing_spectrum_tpu_torch.utils.image import load_rgba
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        pts, txt, png, auto = (os.path.join(tmp, f) for f in (
            "box.pts", "box.txt", "preview.png", "auto.png"))
        scene_io.save_scene(sc, pts)
        sh = SpectrumShell(stdin=io.StringIO(""), stdout=out, device=dev)

        def cmd(line):   # as cmdloop runs a line: onecmd, then postcmd
            return sh.postcmd(sh.onecmd(line), line)

        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        cmd(f"open {pts}")
        cmd(f"render {spp}")
        deadline = t0 + ASYNC_DEADLINE_S
        while (sh.session.status != RenderStatus.PAUSED
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        render_s = time.perf_counter() - t0
        for line in ("status", f"export {txt}", f"preview {png}",
                     f"autopreview on {auto}", "select 0",
                     "autopreview off", "quit"):
            check(bool(cmd(line)) == (line == "quit"), f"shell {line!r}")
        torch.cuda.synchronize()
        got = counts()
        img = sh.session.result()
        exported = open(txt).read() == spectral_io.format_spectrum(img)
        rgb = np.round(load_rgba(png)[..., :3] * 255.0).astype(np.uint8)
        w, h = sh.scene.resolution
        sh.scene.select_object(0, False)   # as at the preview command
        same_png = np.array_equal(rgb, preview.preview_render(
            sh.scene, w, h, rgb=True, device=dev))
        thread_alive = sh.session._thread.is_alive()
    want = {k: v * spp for k, v in want_counts(1, DEPTH).items()}
    want["intersect_dense"] += 3          # preview, autopreview, select
    say("shell", res=f"{w}x{h}", spp=sh.session.samples,
        paused_after_s=render_s, launches=json.dumps(got),
        expected=json.dumps(want), export_equals_result=exported,
        preview_png_equals_preview_render=same_png,
        thread_alive_after_quit=thread_alive, mean=float(img.mean()),
        card=repr(card))
    for line in out.getvalue().splitlines():
        say("shell", stdout=repr(line))
    check(sh.session.samples == spp, f"shell rendered {sh.session.samples}")
    check(got == want, f"shell launches {got}, expected {want}")
    check(exported, "the shell's export is not the session's image")
    check(same_png, "the shell's preview PNG is not preview_render's")
    check(not thread_alive, "the shell's render thread outlived quit")
    healthy(img, "shell")
    return got


def finish(torch) -> None:
    """End on purpose: no kernel in flight, no session thread left, the
    port's device memory released, the output flushed."""
    torch.cuda.synchronize()
    threads = [t.name for t in threading.enumerate()
               if t is not threading.main_thread()]
    check(not threads, f"threads still running at the end: {threads}")
    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile 4 samples of each path with torch.profiler")
    args = ap.parse_args()

    import torch

    # ---- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels run only on a CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the package {PKG}/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch import _build, engine, reorder
    from pathtracing_spectrum_tpu_torch.models.camera import tile_order
    from pathtracing_spectrum_tpu_torch.ops import (
        fetch_cuda, intersect_cluster_cuda, intersect_cuda,
        intersect_hier_cuda, rng, rng_cuda)
    from pathtracing_spectrum_tpu_torch.ops.intersect import pack_tri16
    k3_fn, k4_fn = (intersect_hier_cuda.intersect_bvh,
                    intersect_cluster_cuda.intersect_cluster)

    def counts():
        return {"intersect_dense": intersect_cuda.intersect_dense.launches,
                "fetch_rows": fetch_cuda.fetch_rows.launches,
                "intersect_bvh": k3_fn.launches,
                "intersect_cluster": k4_fn.launches,
                "threefry_uniform": rng_cuda.uniform.launches,
                "sorts": reorder.permutation.calls}

    def zero_counts():
        for fn in (intersect_cuda.intersect_dense, fetch_cuda.fetch_rows,
                   k3_fn, k4_fn, rng_cuda.uniform):
            fn.launches = 0
        reorder.permutation.calls = 0

    def phase_done(phase, t_start):
        say(phase, phase_seconds=f"{time.perf_counter() - t_start:.2f}")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    card = smi.stdout.strip().splitlines()[0]
    # the card's own top SM clock and SM count price its integer issue rate
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, timeout=60, check=True).stdout.split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops_per_s = INT32_OPS_PER_CLK_SM * n_sms * max_sm_mhz * 1e6
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=repr(
            torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    say("env", nvcc=repr(nvcc), sms=n_sms, max_sm_mhz=max_sm_mhz)
    print(card, flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    host = _build.load_host()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_seconds():.2f}",
        library=os.path.relpath(lib._name, HERE),
        host_library=os.path.relpath(host._name, HERE))

    # ---- 2b. threefry against its plain version and jax.random ----------
    t_phase = time.perf_counter()
    g = RNG_GOLDEN
    gkey = rng.key(g["seed"])
    for data, words in g["fold_in"].items():
        check(tuple(rng.fold_in(gkey, data)) == tuple(words),
              f"fold_in(key({g['seed']}), {data}) is not jax.random's")
    rng_key = rng.fold_in(gkey, g["uniform_fold"])
    n_main = g["uniform_shape"][1]
    rng_err = 0.0
    for shape, k, golden in (
            (g["uniform_shape"], rng_key, g["uniform_bits"]),
            ((n_main,), rng.fold_in(gkey, engine.HERO_FOLD),
             (g["hero_bits"],))):
        got = rng_cuda.uniform(k, shape, dev)
        want = rng.uniform_ref(k, shape, dev)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = (got - want).abs().max().item()
        rng_err = max(rng_err, err)
        bits = got.view(torch.int32).reshape(-1, shape[-1]).cpu().numpy()
        jax_same = all(tuple(int(b) & 0xFFFFFFFF for b in bits[r, :len(row)])
                       == tuple(row) for r, row in enumerate(golden))
        say("rng", shape=list(shape), bitwise_equal=same,
            jax_golden_equal=jax_same, max_abs_err=err,
            mean=got.mean().item(), gate="bitwise")
        check(same and jax_same, f"threefry differs at shape {shape}")
    rng_ms = {}
    for shape in (g["uniform_shape"], (n_main,)):
        rng_ms[shape] = time_pair(
            torch, lambda: rng_cuda.uniform(rng_key, shape, dev),
            lambda: rng.uniform_ref(rng_key, shape, dev))
        say("rng", shape=list(shape), kernel_ms=f"{rng_ms[shape][0]:.4f}",
            plain_ms=f"{rng_ms[shape][1]:.4f}", card=repr(card))
    n_draw = int(np.prod(g["uniform_shape"]))
    rng_bound = bound(4 * n_draw, THREEFRY_INT_OPS * n_draw, int32_ops_per_s)
    say("rng", shape=list(g["uniform_shape"]), bound_ms=rng_bound[0],
        bound_by=rng_bound[1], int32_ops_per_s=int32_ops_per_s,
        share_of_bound=rng_bound[0] / rng_ms[g["uniform_shape"]][0])
    phase_done("rng", t_phase)

    # ---- 3. K1 against its plain version ----------------------------------
    t_phase = time.perf_counter()
    sc = tiny_scene(pt, RES)
    scene = sc.compile(dev)
    ro, rd = pt.camera_rays(sc.camera(), RES, RES, device=dev)
    prim = [ro[:, k].contiguous() for k in range(3)] + \
        [rd[:, k].contiguous() for k in range(3)]
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    k1_err = 0.0
    soup = random_soup(torch, dev, 2000, 65536, seed=3)
    cases = {"cornell-primary": (prim, tri16), "soup-2000": soup[:2]}
    for name, (planes, tri) in cases.items():
        want = intersect_cuda.intersect_dense_ref(*planes, tri)
        got = intersect_cuda.intersect_dense(*planes, tri)
        torch.cuda.synchronize()
        agree = (got[2] == want[2]) & (got[0] == want[0])
        pct = agree.float().mean().item() * 100.0
        both = agree & want[0]
        rel_t = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)
                 )[both].max().item() if both.any() else 0.0
        d = [(got[j] - want[j]).abs()[agree].max().item() for j in (1, 3, 4)]
        k1_err = max(k1_err, *d)
        say("K1", case=name, rays=planes[0].shape[0], tris=tri.shape[0],
            hit_pct=f"{want[0].float().mean().item() * 100:.2f}",
            idx_agree_pct=f"{pct:.4f}", max_rel_dt=rel_t, max_abs_dt=d[0],
            max_abs_ds2=d[1], max_abs_ds3=d[2],
            gate=f">={AGREE_GATE_PCT}%")
        check(pct >= AGREE_GATE_PCT, f"K1 idx agreement {pct:.4f}% on {name}")
        check(want[0].any().item(), f"K1 case {name} hits nothing")
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K1 is not bitwise its plain version on {name}")
        if name == "cornell-primary":
            prim_hit = got
    k1_ms, k1_plain_ms = time_pair(
        torch, lambda: intersect_cuda.intersect_dense(*prim, tri16),
        lambda: intersect_cuda.intersect_dense_ref(*prim, tri16))
    n_prim, t_cornell = prim[0].shape[0], tri16.shape[0]
    k1_bound = bound(n_prim * (RAY_BYTES + HIT_BYTES) + t_cornell * 64,
                     n_prim * t_cornell * TRI_TEST_OPS)
    say("K1", shape=f"N={n_prim},T={t_cornell}", kernel_ms=f"{k1_ms:.4f}",
        plain_ms=f"{k1_plain_ms:.4f}", bound_ms=k1_bound[0],
        bound_by=k1_bound[1], share_of_bound=k1_bound[0] / k1_ms,
        card=repr(card))
    phase_done("K1", t_phase)

    # ---- 4. K2 against its plain version ----------------------------------
    t_phase = time.perf_counter()
    shade_sub = engine._prepare(scene, "auto").shade_sub
    t_count = shade_sub.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    edge = torch.tensor([-1, t_count, -7, 1 << 30, 0, t_count - 1],
                        dtype=torch.int32, device=dev)
    rand_idx = torch.randint(-2, t_count + 2, (65536,), generator=g,
                             device=dev, dtype=torch.int32)
    big = torch.randn((2300, 30), generator=g, device=dev)
    big_idx = torch.randint(-2, 2302, (65536,), generator=g, device=dev,
                            dtype=torch.int32)
    k2_err = 0.0
    for name, idx, table in (
            ("cornell-primary", torch.cat([prim_hit[2], rand_idx, edge]),
             shade_sub),
            ("table-2300x30", torch.cat([big_idx, edge]), big)):
        want = fetch_cuda.fetch_rows_ref(idx, table)
        got = fetch_cuda.fetch_rows(idx, table)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = (got - want).abs().max().item()
        k2_err = max(k2_err, err)
        say("K2", case=name, rays=idx.shape[0],
            table=f"{table.shape[0]}x{table.shape[1]}", bitwise_equal=same,
            max_abs_err=err, gate="bitwise")
        check(same and got.shape == want.shape, f"K2 differs on {name}")
    main_idx = prim_hit[2]
    k2_ms, k2_plain_ms = time_pair(
        torch, lambda: fetch_cuda.fetch_rows(main_idx, shade_sub),
        lambda: fetch_cuda.fetch_rows_ref(main_idx, shade_sub))
    # the yardstick: one PyTorch call of the same function on in-range
    # rows, the table transposed outside the timing (the port never calls
    # it)
    table_t = shade_sub.t().contiguous()
    same = torch.equal(torch.index_select(table_t, 1, main_idx),
                       fetch_cuda.fetch_rows(main_idx, shade_sub))
    k2_lib_ms = time_fn(torch, lambda: torch.index_select(table_t, 1,
                                                          main_idx))
    n_f = shade_sub.shape[1]
    k2_bound = bound(4 * main_idx.shape[0] * (1 + n_f) + 4 * t_count * n_f)
    say("K2", shape=f"N={main_idx.shape[0]},T={t_count},F={n_f}",
        kernel_ms=f"{k2_ms:.4f}", plain_ms=f"{k2_plain_ms:.4f}",
        index_select_ms=f"{k2_lib_ms:.4f}", index_select_equal=same,
        bound_ms=k2_bound[0], bound_by=k2_bound[1],
        share_of_bound=k2_bound[0] / k2_ms, card=repr(card))
    check(same, "K2 differs from index_select on in-range rows")
    phase_done("K2", t_phase)

    # ---- 5. shared variates: the trace on the card vs on the CPU ----------
    t_phase = time.perf_counter()
    sc64 = tiny_scene(pt, TRACE_RES)
    ro64, rd64 = pt.camera_rays(sc64.camera(), TRACE_RES, TRACE_RES, "cpu")
    n64 = ro64.shape[0]
    rand = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2 * DEPTH, 4, n64)).astype(np.float32))
    hits = {}
    original = intersect_cuda.intersect_dense

    def recording(*a):
        out = original(*a)
        hits.setdefault(a[0].device.type, []).append(
            (out[0].cpu(), out[2].cpu()))
        return out

    # the wrapper counts its launches on the module's intersect_dense,
    # which is this recorder while it is patched in
    recording.launches = 0
    intersect_cuda.intersect_dense = recording
    try:
        on_cpu = engine.trace_radiance(sc64.compile("cpu"), ro64, rd64, None,
                                       DEPTH, rand_override=rand)
        on_dev = engine.trace_radiance(sc64.compile(dev), ro64.to(dev),
                                       rd64.to(dev), None, DEPTH,
                                       rand_override=rand.to(dev))
        torch.cuda.synchronize()
    finally:
        intersect_cuda.intersect_dense = original
    differs = torch.zeros(n64, dtype=torch.bool)
    for (hc, ic), (hd, idd) in zip(hits["cpu"], hits["cuda"]):
        differs |= (hc != hd) | (ic != idd)
    a, b = on_dev.radiance.cpu()[~differs], on_cpu.radiance[~differs]
    close = torch.allclose(a, b, rtol=TRACE_RTOL, atol=TRACE_ATOL)
    n_diff = int(differs.sum())
    say("trace", pixels=n64, depth=DEPTH, bounces=len(hits["cuda"]),
        pixels_with_other_hits=n_diff,
        max_abs_diff_elsewhere=(a - b).abs().max().item(),
        rays_cuda=int(on_dev.rays_traced), rays_cpu=int(on_cpu.rays_traced),
        tolerance=f"rtol={TRACE_RTOL},atol={TRACE_ATOL}")
    check(len(hits["cuda"]) == len(hits["cpu"]) == 2 * DEPTH,
          "the trace did not sweep once per bounce")
    check(close, "CUDA and CPU traces differ beyond tolerance")
    check(n_diff <= n64 * (100.0 - AGREE_GATE_PCT) / 100.0,
          f"{n_diff} pixels hit other triangles on the card")
    phase_done("trace", t_phase)

    # ---- 6. main path: RenderSession on the card --------------------------
    t_phase = time.perf_counter()
    warm = pt.RenderSession(sc, dev, seed=1)
    warm.run(2, batch=2)
    torch.cuda.synchronize()
    sess = pt.RenderSession(sc, dev, seed=0)
    img, main_counts = drive(torch, sess, SPP, counts, zero_counts)
    launches = {k: main_counts[k] for k in ("intersect_dense", "fetch_rows")}
    st = sess.stats()
    want_launches = 1 + SPP * (2 * DEPTH - 1)
    want_draws = SPP * 2 * DEPTH     # one [4, N] draw per bounce iteration
    h = img.shape[0]
    top, bottom = img[: h // 8].mean(), img[-(h // 8):].mean()
    say("main", res=f"{RES}x{RES}", nw=img.shape[2], depth=DEPTH, spp=SPP,
        launches_K1=launches["intersect_dense"],
        launches_K2=launches["fetch_rows"], expected=want_launches,
        launches_threefry=main_counts["threefry_uniform"],
        expected_threefry=want_draws,
        rays_traced=st["rays_traced"], mean=float(img.mean()),
        top_band=float(top), bottom_band=float(bottom))
    check(main_counts == want_counts(SPP, DEPTH),
          f"main path launches {main_counts}, expected "
          f"{want_counts(SPP, DEPTH)}")
    check(st["backend"] == "dense", f"main path resolved {st['backend']}")
    check(isinstance(st["rays_traced"], int)
          and st["rays_traced"] >= SPP * RES * RES, "rays_traced")
    check(img.shape == (RES, RES, 4), f"image shape {img.shape}")
    lit_from_top(img, "main")

    # Mrays/s: more steps of the same session (one render_samples call
    # each), timed with CUDA events; the step ends by reading rays_traced
    mrays, ms_per_sample = (list(v) for v in zip(
        *(timed_step(torch, sess, SPP) for _ in range(2))))
    say("main", mrays_per_s=mrays, ms_per_sample=ms_per_sample,
        session_mrays_per_s=st["mrays_per_s"], card=repr(card))
    if args.profile:
        profile(torch, sess, min(ms_per_sample), "main")
    phase_done("main", t_phase)

    # ---- 7. terrain: the large-scene configuration -------------------------
    t_phase = time.perf_counter()
    path52 = make_terrain("52k")
    path10 = make_terrain("10k")
    sc52 = terrain_scene(pt, path52, RES)
    t0 = time.perf_counter()
    scene52 = sc52.compile(dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    nodes52 = (scene52.bvh_node_min, scene52.bvh_node_max,
               scene52.bvh_node_skip, scene52.bvh_node_first,
               scene52.bvh_node_count)
    tri52 = pack_tri16(scene52.tri_face_n, scene52.tri_k1, scene52.tri_k2,
                       scene52.tri_k3, scene52.tri_consts)
    say("terrain", triangles=scene52.n_triangles,
        bvh_nodes=scene52.bvh_node_min.shape[0],
        clusters=scene52.cluster_aabbs.shape[0],
        compile_seconds=f"{compile_s:.2f}")
    check(scene52.n_triangles == 51778, "terrain_52k triangle count")
    ro52, rd52 = pt.camera_rays(sc52.camera(), RES, RES, device=dev)
    prim52 = [ro52[:, k].contiguous() for k in range(3)] + \
        [rd52[:, k].contiguous() for k in range(3)]
    bounce_rays = rays_of_bounce(scene52, ro52, rd52, 2)
    phase_done("terrain", t_phase)

    # ---- 8. K3 and K4 against their plain versions -------------------------
    # K3's cases: (planes, table, node arrays, cluster boxes, packed BVH);
    # the constructed tie (one triangle at rows 1 and 2, met in descending
    # index) and a tree deeper than K3's local stack are K3's alone.
    # K4's cases: (planes, table, packed cluster and group boxes), K3's
    # first three and K4's own tie (one triangle at rows 5 and 1030, the
    # higher row's cluster entered first)
    cases_mod = load_by_path("torch_cases", os.path.join(HERE, "tests",
                                                         "torch_cases.py"))
    pack = intersect_hier_cuda.pack_bvh
    packed52 = pack(*nodes52)
    hier_cases = {
        "terrain-primary": (prim52, tri52, nodes52, scene52.cluster_aabbs,
                            packed52),
        "soup-2000": soup + (pack(*soup[2]),),
        "terrain-bounce2": (bounce_rays, tri52, nodes52,
                            scene52.cluster_aabbs, packed52)}
    tie_tri, tie_nodes, tie_planes = cases_mod.tie_case()
    chain_tri, chain_nodes = cases_mod.chain_bvh(80)
    chain_planes = [torch.tensor(v, dtype=torch.float32) for v in (
        [0.1, 0.5, 0.3, 9.0], [0.1, 0.2, 0.3, 9.0], [-1.0, -3.0, 40.5, -1.0],
        [0.0] * 4, [0.0] * 4, [1.0] * 4)]
    k3_only = {}
    for case, (planes, tri, nodes) in (
            ("tie-descending", (tie_planes, tie_tri, tie_nodes)),
            ("chain-depth-80", (chain_planes, chain_tri, chain_nodes))):
        nodes = tuple(a.to(dev) for a in nodes)
        k3_only[case] = ([p.to(dev) for p in planes], tri.to(dev), nodes,
                         None, pack(*nodes))
    check(k3_only["chain-depth-80"][4].depth > intersect_hier_cuda.LOCAL_STACK,
          "the chain does not reach past K3's local stack")
    pack_cl = intersect_cluster_cuda.pack_clusters
    k4_cases = {case: (c[0], c[1], pack_cl(c[3]))
                for case, c in hier_cases.items()}
    ct_tri, ct_caabb, ct_planes = cases_mod.cluster_tie_case()
    k4_cases["tie-nearest-cluster"] = ([p.to(dev) for p in ct_planes],
                                       ct_tri.to(dev),
                                       pack_cl(ct_caabb.to(dev)))
    dense52 = intersect_cuda.intersect_dense(*prim52, tri52)
    hier_err, hier_ms, walks, sweeps = {}, {}, {}, {}

    def walk_counts(c):
        """(skip-link walk's box and triangle tests, the ordered walk's, the
        ordered walk's most for one ray) on case ``c``: the plain version's
        counters and K3's counting build."""
        stats = {}
        intersect_hier_cuda.intersect_bvh_ref(*c[0], c[1], *c[2],
                                              stats=stats)
        counts = torch.zeros((2, c[0][0].shape[0]), dtype=torch.int32,
                             device=dev)
        k3_fn(*c[0], c[1], c[4], counts=counts)
        return ((stats["boxes"], stats["tris"]),
                tuple(counts.sum(dim=1).tolist()),
                tuple(counts.max(dim=1).values.tolist()))

    def k3_bound(c, counts):
        """K3's bound on case ``c``: each ray read and its hit written, the
        table and the node records read once, and the fewer of the two
        walks' operations. K4 is held to the same bound on the same rays:
        its function is K3's, and it needs no more work than they do."""
        n = c[0][0].shape[0]
        nbytes = (n * (RAY_BYTES + HIT_BYTES) + c[1].shape[0] * 64
                  + c[4].records.shape[0] * 64)
        return bound(nbytes, min(walk_ops(*w) for w in counts[:2]))

    def sweep_counts(c):
        """K4's counting build on case ``c``: the sums and the maxima over
        the rays of their box tests, their warp's row-test steps and their
        warp's swept clusters."""
        counts = torch.zeros((3, c[0][0].shape[0]), dtype=torch.int32,
                             device=dev)
        k4_fn(*c[0], c[1], c[2], counts=counts)
        return {"box_tests_row_steps_clusters_sum":
                    counts.sum(dim=1).tolist(),
                "box_tests_row_steps_clusters_max":
                    counts.max(dim=1).values.tolist()}

    for label, name, kernel, plain, cases in (
            ("K3", "intersect_bvh",
             lambda c: k3_fn(*c[0], c[1], c[4]),
             lambda c: intersect_hier_cuda.intersect_bvh_ref(*c[0], c[1],
                                                             *c[2]),
             {**hier_cases, **k3_only}),
            ("K4", "intersect_cluster",
             lambda c: k4_fn(*c[0], c[1], c[2]),
             lambda c: intersect_cluster_cuda.intersect_cluster_ref(
                 *c[0], c[1], c[2].aabbs), k4_cases)):
        t_phase = time.perf_counter()
        hier_err[name] = 0.0
        for case, c in cases.items():
            want = plain(c)
            got = kernel(c)
            torch.cuda.synchronize()
            pct, err, hits = agreement(got, want)
            hier_err[name] = max(hier_err[name], err)
            fields = {}
            if case == "terrain-primary":
                pct_dense, _, _ = agreement(got, dense52)
                fields["idx_agree_vs_K1_pct"] = f"{pct_dense:.4f}"
                check(pct_dense >= AGREE_GATE_PCT,
                      f"{label} vs K1 agreement {pct_dense:.4f}% on {case}")
            if case == "soup-2000":
                check(not got[0][::7].any().item(),
                      f"{label}: a parked ray hit on {case}")
            if label == "K3":
                walks[case] = walk_counts(c)
                fields.update(skiplink_box_tri_tests=list(walks[case][0]),
                              ordered_box_tri_tests=list(walks[case][1]),
                              longest_ray_box_tri_tests=list(walks[case][2]))
            else:
                sweeps[case] = sweep_counts(c)
                fields.update(sweeps[case])
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{label} is not bitwise its plain version on {case}")
            fields["bitwise_equal"] = True
            say(label, case=case, rays=c[0][0].shape[0],
                tris=c[1].shape[0], hits=hits, idx_agree_pct=f"{pct:.4f}",
                max_abs_err=err, gate=f">={AGREE_GATE_PCT}%", **fields)
            check(pct >= AGREE_GATE_PCT,
                  f"{label} idx agreement {pct:.4f}% on {case}")
            check(hits > 0, f"{label} case {case} hits nothing")
        if label == "K3":
            check(int(kernel(k3_only["tie-descending"])[2].item()) == 1,
                  "K3 did not give the tie to the lower row")
        else:
            check(int(kernel(k4_cases["tie-nearest-cluster"])[2].item())
                  == 5, "K4 did not give the tie to the lower row")
        for shape in ("terrain-primary", "terrain-bounce2"):
            c = cases[shape]
            hier_ms[name, shape] = time_pair(
                torch, lambda: kernel(c), lambda: plain(c), plain_iters=2,
                plain_warmup=1)
            b_ms, b_by = k3_bound(hier_cases[shape], walks[shape])
            say(label, case=shape,
                shape=f"N={c[0][0].shape[0]},T={c[1].shape[0]}",
                kernel_ms=f"{hier_ms[name, shape][0]:.4f}",
                plain_ms=f"{hier_ms[name, shape][1]:.4f}", bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / hier_ms[name, shape][0],
                **(sweeps[shape] if label == "K4" else {}), card=repr(card))
        phase_done(label, t_phase)

    # K2 on the terrain's table (51,778 rows, read through the cache)
    t_phase = time.perf_counter()
    shade52 = engine._prepare(scene52, "auto").shade_sub
    idx52 = torch.cat([dense52[2], edge])
    same = torch.equal(fetch_cuda.fetch_rows(idx52, shade52).view(torch.int32),
                       fetch_cuda.fetch_rows_ref(idx52, shade52)
                       .view(torch.int32))
    k2_52_ms, k2_52_plain_ms = time_pair(
        torch, lambda: fetch_cuda.fetch_rows(dense52[2], shade52),
        lambda: fetch_cuda.fetch_rows_ref(dense52[2], shade52))
    say("K2", case="terrain-primary",
        table=f"{shade52.shape[0]}x{shade52.shape[1]}", bitwise_equal=same,
        kernel_ms=f"{k2_52_ms:.4f}", plain_ms=f"{k2_52_plain_ms:.4f}",
        card=repr(card))
    check(same, "K2 differs on the terrain table")
    phase_done("K2-terrain", t_phase)

    # ---- 9. shared variates: terrain traces through K3 and K4 -------------
    t_phase = time.perf_counter()
    sc10 = terrain_scene(pt, path10, TRACE_RES)
    ro10, rd10 = pt.camera_rays(sc10.camera(), TRACE_RES, TRACE_RES, "cpu")
    n10 = ro10.shape[0]
    rand10 = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (2 * DEPTH, 4, n10)).astype(np.float32))
    scene10_cpu, scene10_dev = sc10.compile("cpu"), sc10.compile(dev)
    for backend in ("hier", "cluster"):
        fetched = {}
        real_fetch = fetch_cuda.fetch_rows

        def recording_fetch(idx, table):
            fetched.setdefault(idx.device.type, []).append(idx.cpu())
            return real_fetch(idx, table)

        recording_fetch.launches = 0
        fetch_cuda.fetch_rows = recording_fetch
        sorts0 = reorder.permutation.calls
        try:
            on_cpu = engine.trace_radiance(scene10_cpu, ro10, rd10, None,
                                           DEPTH, backend=backend,
                                           rand_override=rand10)
            sorts_cpu = reorder.permutation.calls - sorts0
            on_dev = engine.trace_radiance(scene10_dev, ro10.to(dev),
                                           rd10.to(dev), None, DEPTH,
                                           backend=backend,
                                           rand_override=rand10.to(dev))
            torch.cuda.synchronize()
        finally:
            fetch_cuda.fetch_rows = real_fetch
        sorts_dev = reorder.permutation.calls - sorts0 - sorts_cpu
        # fetch_rows gets each bounce's winners in ray order, sorted or not
        differs = torch.zeros(n10, dtype=torch.bool)
        for ic, idd in zip(fetched["cpu"], fetched["cuda"]):
            differs |= ic != idd
        a, b = on_dev.radiance.cpu()[~differs], on_cpu.radiance[~differs]
        close = torch.allclose(a, b, rtol=TRACE_RTOL, atol=TRACE_ATOL)
        n_diff = int(differs.sum())
        say("trace", scene="terrain-10k", backend=backend, pixels=n10,
            tris=scene10_dev.n_triangles, depth=DEPTH,
            bounces=len(fetched["cuda"]), sorts_on_card=sorts_dev,
            pixels_with_other_hits=n_diff,
            max_abs_diff_elsewhere=(a - b).abs().max().item(),
            rays_cuda=int(on_dev.rays_traced),
            rays_cpu=int(on_cpu.rays_traced),
            tolerance=f"rtol={TRACE_RTOL},atol={TRACE_ATOL}")
        check(len(fetched["cuda"]) == len(fetched["cpu"]) == 2 * DEPTH,
              "the terrain trace did not fetch once per bounce")
        check(sorts_cpu == 0 and sorts_dev == 2 * DEPTH - 2,
              f"reorder ran {sorts_cpu} times on the CPU and {sorts_dev} "
              "on the card")
        check(close, f"{backend}: CUDA and CPU terrain traces differ beyond "
              "tolerance")
        check(n_diff <= n10 * (100.0 - AGREE_GATE_PCT) / 100.0,
              f"{backend}: {n_diff} pixels hit other triangles on the card")
    phase_done("trace-terrain", t_phase)

    # ---- 10. large-scene path: RenderSession on the terrain ---------------
    t_phase = time.perf_counter()
    warm = pt.RenderSession(sc52, dev, seed=1)
    warm.run(2, batch=2)
    torch.cuda.synchronize()
    sess52 = pt.RenderSession(sc52, dev, seed=0)
    img52, large_counts = drive(torch, sess52, LARGE_SPP, counts, zero_counts)
    st52 = sess52.stats()
    want52 = 1 + LARGE_SPP * (2 * DEPTH - 1)
    say("large", res=f"{RES}x{RES}", tris=scene52.n_triangles,
        backend=st52["backend"], spp=LARGE_SPP, expected=want52,
        launches_K1=large_counts["intersect_dense"],
        launches_K2=large_counts["fetch_rows"],
        launches_K3=large_counts["intersect_bvh"],
        launches_K4=large_counts["intersect_cluster"],
        sorts=large_counts["sorts"], rays_traced=st52["rays_traced"],
        mean=float(img52.mean()))
    check(st52["backend"] == "hier", f"terrain resolved {st52['backend']}")
    # the reorder sorts every looped iteration at 52k triangles
    want = want_counts(LARGE_SPP, DEPTH, route="intersect_bvh",
                       sorts=LARGE_SPP * (2 * DEPTH - 1))
    check(large_counts == want,
          f"large-scene launches {large_counts}, expected {want}")
    check(img52.shape == (RES, RES, 4), f"image shape {img52.shape}")
    healthy(img52, "terrain")

    # Mrays/s with the reorder on ("auto") and off, in turns, through
    # render_samples on the session's rays, timed with CUDA events
    perm, _ = tile_order(RES, RES)
    perm_t = torch.from_numpy(perm.astype(np.int64)).to(dev)
    ro_t, rd_t = ro52[perm_t], rd52[perm_t]
    rates = {"auto": [], False: []}
    for mode in ("auto", False, False, "auto"):
        total = torch.zeros((RES * RES, 4), device=dev)
        engine.render_samples(scene52, ro_t, rd_t, total, 0, rng.key(3), 0,
                              n_steps=1, max_depth=DEPTH, reorder=mode)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        _, _, _, rays = engine.render_samples(
            scene52, ro_t, rd_t, total, 0, rng.key(3), 100,
            n_steps=LARGE_SPP, max_depth=DEPTH, reorder=mode)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
        rates[mode].append((int(rays) / ms / 1e3, ms / LARGE_SPP))
    for mode, vals in rates.items():
        say("large", reorder=mode, mrays_per_s=[v[0] for v in vals],
            ms_per_sample=[v[1] for v in vals], card=repr(card))
    if args.profile:
        profile(torch, sess52, min(v[1] for v in rates["auto"]), "large")

    # the second entry point: backend="cluster" on the same scene
    sess_c = pt.RenderSession(sc52, dev, seed=0, backend="cluster")
    img_c, cluster_counts = drive(torch, sess_c, CLUSTER_SPP, counts,
                                  zero_counts)
    st_c = sess_c.stats()
    want_c = 1 + CLUSTER_SPP * (2 * DEPTH - 1)
    say("cluster", backend=st_c["backend"], spp=CLUSTER_SPP,
        expected=want_c, launches_K4=cluster_counts["intersect_cluster"],
        launches_K2=cluster_counts["fetch_rows"],
        launches_K3=cluster_counts["intersect_bvh"],
        sorts=cluster_counts["sorts"], mrays_per_s=st_c["mrays_per_s"],
        mean=float(img_c.mean()), card=repr(card))
    check(st_c["backend"] == "cluster", "cluster session backend")
    want = want_counts(CLUSTER_SPP, DEPTH, route="intersect_cluster",
                       sorts=CLUSTER_SPP * (2 * DEPTH - 1))
    check(cluster_counts == want,
          f"cluster launches {cluster_counts}, expected {want}")
    healthy(img_c, "cluster")
    phase_done("large", t_phase)

    def rate(sess, n):
        """(Mrays/s, ms per sample, counts) of one more ``step(n)`` of the
        session, timed with CUDA events."""
        torch.cuda.synchronize()
        zero_counts()
        mr, ms = timed_step(torch, sess, n)
        return mr, ms, counts()

    # ---- 11. spectral path: the dispersion prism, then nw = 256 ----------
    t_phase = time.perf_counter()
    scp = prism_scene(pt, RES)
    warm = pt.RenderSession(scp, dev, seed=1, dispersion=True)
    warm.run(2, batch=2)
    torch.cuda.synchronize()
    sess_p = pt.RenderSession(scp, dev, seed=0, dispersion=True)
    img_p, prism_counts = drive(torch, sess_p, PRISM_SPP, counts, zero_counts)
    st_p = sess_p.stats()
    want_p = want_counts(PRISM_SPP, PRISM_DEPTH, hero=True)
    say("spectral", scene="prism", res=f"{RES}x{RES}", dispersion=True,
        depth=PRISM_DEPTH, spp=PRISM_SPP, tris=st_p["triangles"],
        backend=st_p["backend"], launches=json.dumps(prism_counts),
        expected=json.dumps(want_p), rays_traced=st_p["rays_traced"],
        mean=float(img_p.mean()))
    check(st_p["backend"] == "dense", f"prism resolved {st_p['backend']}")
    check(prism_counts == want_p, f"prism launches {prism_counts}, "
          f"expected {want_p}")
    check(img_p.shape == (RES, RES, 4), f"prism image shape {img_p.shape}")
    healthy(img_p, "prism")
    mr, ms, _ = rate(sess_p, PRISM_SPP)
    say("spectral", scene="prism", mrays_per_s=mr, ms_per_sample=ms,
        card=repr(card))
    if args.profile:
        profile(torch, sess_p, ms, "spectral")
    # K2 on the flat hero table, misses and out-of-range rows included
    prep_p = engine._prepare(sess_p._scene_data, "auto", dispersion=True)
    ro_p, rd_p = pt.camera_rays(scp.camera(), RES, RES, device=dev)
    prim_p = prep_p.intersect(*(ro_p[:, k].contiguous() for k in range(3)),
                              *(rd_p[:, k].contiguous() for k in range(3)))
    hero = torch.randint(0, 4, prim_p[2].shape, generator=g, device=dev,
                         dtype=torch.int32)
    flat = torch.cat([torch.where(prim_p[0], prim_p[2], -1) * 4 + hero,
                      edge])
    got = fetch_cuda.fetch_rows(flat, prep_p.hero_table)
    want = fetch_cuda.fetch_rows_ref(flat, prep_p.hero_table)
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = (got - want).abs().max().item()
    k2_err = max(k2_err, err)
    say("K2", case="prism-hero-table",
        table="x".join(map(str, prep_p.hero_table.shape)),
        negative_rows=int((flat < 0).sum()), bitwise_equal=same,
        max_abs_err=err, gate="bitwise")
    check(same, "K2 differs on the hero table")

    sc256 = cornell_nw_scene(pt, (RES, RES), NW_BIG)
    for mode in ("hero", False):
        s256 = pt.RenderSession(sc256, dev, seed=0, dispersion=mode)
        s256.run(1, batch=1)
        mr, ms, c256 = rate(s256, NW_SPP)
        want256 = want_counts(NW_SPP, DEPTH, hero=bool(mode))
        img256 = s256.result()
        say("spectral", scene=f"cornell-nw{NW_BIG}", res=f"{RES}x{RES}",
            dispersion=repr(mode), spp=NW_SPP, mrays_per_s=mr,
            ms_per_sample=ms, launches=json.dumps(c256),
            mean=float(img256.mean()), card=repr(card))
        check(c256 == want256, f"nw={NW_BIG} {mode!r} launches {c256}, "
              f"expected {want256}")
        check(img256.shape == (RES, RES, NW_BIG), "nw=256 image shape")
        healthy(img256, f"nw={NW_BIG} {mode!r}")
        del s256, img256
    phase_done("spectral", t_phase)

    # ---- 12. textured path: the checker-roughness sphere at 1080p --------
    t_phase = time.perf_counter()
    sct = textured_sphere_scene(pt, TEX_RES)
    data_t = sct.compile(dev)
    say("textured", tris=data_t.n_triangles,
        texture_table=list(data_t.textures.shape),
        roughness_tex_any=list(data_t.roughness_tex_any.shape),
        normal_tex_any=list(data_t.normal_tex_any.shape))
    check(tuple(data_t.textures.shape) == (1, 128, 128, 4),
          f"texture table {tuple(data_t.textures.shape)}: the checker map "
          "was not decoded")
    check(data_t.roughness_tex_any.shape[0] == 1, "no roughness map bound")
    warm = pt.RenderSession(sct, dev, seed=1)
    warm.run(1, batch=1)
    torch.cuda.synchronize()
    sess_t = pt.RenderSession(sct, dev, seed=0)
    img_t, tex_counts = drive(torch, sess_t, TEX_SPP, counts, zero_counts)
    st_t = sess_t.stats()
    # 2,244 triangles: reorder on ("auto", K3 on CUDA), from the last
    # iteration (reorder_from_policy below 4,096 triangles)
    want_t = want_counts(TEX_SPP, DEPTH, route="intersect_bvh",
                         sorts=TEX_SPP)
    say("textured", res=f"{TEX_RES[0]}x{TEX_RES[1]}", spp=TEX_SPP,
        backend=st_t["backend"], launches=json.dumps(tex_counts),
        expected=json.dumps(want_t), rays_traced=st_t["rays_traced"],
        mean=float(img_t.mean()))
    check(st_t["backend"] == "hier", f"textured resolved {st_t['backend']}")
    check(tex_counts == want_t, f"textured launches {tex_counts}, expected "
          f"{want_t}")
    check(img_t.shape == (TEX_RES[1], TEX_RES[0], 4),
          f"textured image shape {img_t.shape}")
    healthy(img_t, "textured")
    mr, ms, _ = rate(sess_t, TEX_SPP)
    say("textured", mrays_per_s=mr, ms_per_sample=ms, card=repr(card))
    if args.profile:
        profile(torch, sess_t, ms, "textured")
    # K3 in context at 1080p: the session's rays at bounce iteration 2
    nodes_t = (data_t.bvh_node_min, data_t.bvh_node_max,
               data_t.bvh_node_skip, data_t.bvh_node_first,
               data_t.bvh_node_count)
    case = "textured-bounce2"
    c = (rays_of_bounce(data_t, sess_t._ro, sess_t._rd, 2),
         pack_tri16(data_t.tri_face_n, data_t.tri_k1, data_t.tri_k2,
                    data_t.tri_k3, data_t.tri_consts), nodes_t, None,
         pack(*nodes_t))
    want = intersect_hier_cuda.intersect_bvh_ref(*c[0], c[1], *c[2])
    got = k3_fn(*c[0], c[1], c[4])
    torch.cuda.synchronize()
    pct, err, hits = agreement(got, want)
    hier_err["intersect_bvh"] = max(hier_err["intersect_bvh"], err)
    walks[case] = walk_counts(c)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"K3 is not bitwise its plain version on {case}")
    check(hits > 0, f"K3 case {case} hits nothing")
    k3_tex_ms = time_fn(torch, lambda: k3_fn(*c[0], c[1], c[4]))
    b_ms, b_by = k3_bound(c, walks[case])
    say("K3", case=case, rays=c[0][0].shape[0], tris=c[1].shape[0],
        hits=hits, idx_agree_pct=f"{pct:.4f}", max_abs_err=err,
        skiplink_box_tri_tests=list(walks[case][0]),
        ordered_box_tri_tests=list(walks[case][1]),
        longest_ray_box_tri_tests=list(walks[case][2]),
        kernel_ms=f"{k3_tex_ms:.4f}", bound_ms=b_ms, bound_by=b_by,
        share_of_bound=b_ms / k3_tex_ms, card=repr(card))
    # K4 on the same rays, against its plain version and K3's bound
    c4 = (c[0], c[1], intersect_cluster_cuda.pack_clusters(
        data_t.cluster_aabbs))
    want = intersect_cluster_cuda.intersect_cluster_ref(*c4[0], c4[1],
                                                        c4[2].aabbs)
    got = k4_fn(*c4[0], c4[1], c4[2])
    torch.cuda.synchronize()
    pct, err, hits = agreement(got, want)
    hier_err["intersect_cluster"] = max(hier_err["intersect_cluster"], err)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"K4 is not bitwise its plain version on {case}")
    sweeps[case] = sweep_counts(c4)
    hier_ms["intersect_cluster", case] = time_pair(
        torch, lambda: k4_fn(*c4[0], c4[1], c4[2]),
        lambda: intersect_cluster_cuda.intersect_cluster_ref(
            *c4[0], c4[1], c4[2].aabbs), plain_iters=2, plain_warmup=1)
    k4_tex_ms = hier_ms["intersect_cluster", case][0]
    say("K4", case=case, rays=c[0][0].shape[0], tris=c[1].shape[0],
        hits=hits, idx_agree_pct=f"{pct:.4f}", max_abs_err=err,
        bitwise_equal=True, **sweeps[case], kernel_ms=f"{k4_tex_ms:.4f}",
        plain_ms=f"{hier_ms['intersect_cluster', case][1]:.4f}",
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / k4_tex_ms,
        card=repr(card))
    del c, c4, got, want
    phase_done("textured", t_phase)

    # ---- 13. one key: spectral and textured traces, card vs CPU ----------
    t_phase = time.perf_counter()

    def same_key_trace(name, sc_k, depth, **kw):
        ro_k, rd_k = pt.camera_rays(sc_k.camera(), TRACE_RES, TRACE_RES,
                                    "cpu")
        n_k = ro_k.shape[0]
        scene_cpu, scene_dev = sc_k.compile("cpu"), sc_k.compile(dev)
        key = rng.fold_in(rng.key(13), 1)
        fetched = {}
        real_fetch = fetch_cuda.fetch_rows

        def recording_fetch(idx, table):
            if table.shape[0] == scene_cpu.n_triangles:   # not the hero table
                fetched.setdefault(idx.device.type, []).append(idx.cpu())
            return real_fetch(idx, table)

        recording_fetch.launches = 0
        fetch_cuda.fetch_rows = recording_fetch
        try:
            on_cpu = engine.trace_radiance(scene_cpu, ro_k, rd_k, key,
                                           depth, **kw)
            on_dev = engine.trace_radiance(scene_dev, ro_k.to(dev),
                                           rd_k.to(dev), key, depth, **kw)
            torch.cuda.synchronize()
        finally:
            fetch_cuda.fetch_rows = real_fetch
        differs = torch.zeros(n_k, dtype=torch.bool)
        for ic, idd in zip(fetched["cpu"], fetched["cuda"]):
            differs |= ic != idd
        a, b = on_dev.radiance.cpu()[~differs], on_cpu.radiance[~differs]
        close = torch.allclose(a, b, rtol=TRACE_RTOL, atol=TRACE_ATOL)
        n_diff = int(differs.sum())
        say("trace", scene=name, key="fold_in(key(13), 1)", pixels=n_k,
            depth=depth, tris=scene_dev.n_triangles,
            options=json.dumps({k: repr(v) for k, v in kw.items()}),
            pixels_with_other_hits=n_diff,
            max_abs_diff_elsewhere=(a - b).abs().max().item(),
            max_abs=b.abs().max().item(),
            rays_cuda=int(on_dev.rays_traced),
            rays_cpu=int(on_cpu.rays_traced),
            tolerance=f"rtol={TRACE_RTOL},atol={TRACE_ATOL}")
        check(len(fetched["cuda"]) == len(fetched["cpu"]) == 2 * depth,
              f"{name}: the trace did not fetch once per bounce")
        check(close, f"{name}: CUDA and CPU traces differ beyond tolerance")
        check(n_diff <= n_k * (100.0 - AGREE_GATE_PCT) / 100.0,
              f"{name}: {n_diff} pixels hit other triangles on the card")
        check(b.abs().max().item() > 0, f"{name}: the trace is black")

    with tempfile.TemporaryDirectory() as tmp:
        grid = os.path.join(tmp, "back_wall.txt")
        with open(grid, "w") as f:
            f.write("\n".join(" ".join(str(100 + 40 * ((x + y) % 5))
                                       for x in range(9))
                              for y in range(7)) + "\n")
        same_key_trace("prism", prism_scene(pt, TRACE_RES), PRISM_DEPTH,
                       dispersion=True)
        same_key_trace("cornell-nw4",
                       cornell_nw_scene(pt, (TRACE_RES, TRACE_RES), 4),
                       DEPTH, dispersion="hero")
        same_key_trace("textured-grid", textured_sphere_scene(
            pt, (TRACE_RES, TRACE_RES), grid), DEPTH, backend="hier")
    phase_done("trace-one-key", t_phase)

    # ---- 14. the user's session: 4K chunks, jitter, checkpoints --------
    # (each phase holds its kernels at its own shapes: their errors join
    # the kernels line's)
    t_phase = time.perf_counter()
    errs, sess_4k = chunks_4k_phase(torch, pt, dev, card, counts,
                                    zero_counts, with_profile=args.profile)
    phase_done("4k-chunks", t_phase)
    t_phase = time.perf_counter()
    jitter_phase(torch, pt, dev, card, counts, zero_counts,
                 with_profile=args.profile)
    jitter_trace(torch, pt, dev)
    phase_done("jitter", t_phase)
    t_phase = time.perf_counter()
    ckpt_errs = checkpoint_phase(torch, pt, dev, card, counts, zero_counts,
                                 sc52, sc)
    phase_done("checkpoint", t_phase)
    t_phase = time.perf_counter()
    surf_launches, surf_errs = surface_phase(
        torch, pt, dev, card, counts, zero_counts, (sc, scene),
        (sc52, scene52), sess_4k)
    phase_done("surface", t_phase)
    t_phase = time.perf_counter()
    files_launches = files_phase(torch, pt, dev, card, counts, zero_counts,
                                 sess_4k)
    del sess_4k
    phase_done("files", t_phase)
    t_phase = time.perf_counter()
    multi_launches, multi_errs = multi_phase(torch, pt, dev, card, counts,
                                             zero_counts, sc, sc52)
    phase_done("multi", t_phase)
    t_phase = time.perf_counter()
    shell_phase(torch, pt, dev, card, counts, zero_counts, sc)
    phase_done("shell", t_phase)
    k1_err = max(k1_err, errs["intersect_dense"],
                 surf_errs.get("intersect_dense", 0.0),
                 multi_errs["intersect_dense"])
    k2_err = max(k2_err, errs["fetch_rows"], ckpt_errs["fetch_rows"],
                 multi_errs["fetch_rows"])
    rng_err = max(rng_err, errs["threefry_uniform"],
                  ckpt_errs["threefry_uniform"],
                  multi_errs["threefry_uniform"])
    hier_err["intersect_bvh"] = max(hier_err["intersect_bvh"],
                                    ckpt_errs["intersect_bvh"],
                                    surf_errs.get("intersect_bvh", 0.0),
                                    multi_errs["intersect_bvh"])

    check(not any(m.split(".")[0] in ("jax", "jaxlib")
                  for m in sys.modules), "jax was imported")
    src = "pathtracing_spectrum_tpu_torch/csrc/"
    k_main = "terrain-bounce2"
    k3_b = k3_bound(hier_cases[k_main], walks[k_main])
    kernels = [
        {"name": "intersect_dense", "route": "cuda",
         "source": src + "intersect_dense.cu",
         "replaces": "pathtracing_spectrum_tpu/ops/intersect_pallas.py:43",
         "launches": launches["intersect_dense"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "fetch_rows", "route": "cuda",
         "source": src + "fetch_rows.cu",
         "replaces": "pathtracing_spectrum_tpu/ops/fetch_pallas.py:32",
         "launches": launches["fetch_rows"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": k2_lib_ms},
        {"name": "intersect_bvh", "route": "cuda",
         "source": src + "intersect_bvh.cu",
         "replaces": ("pathtracing_spectrum_tpu/ops/intersect_shortlist.py"
                      ":549, pathtracing_spectrum_tpu/ops/"
                      "intersect_worklist.py:101"),
         "launches": large_counts["intersect_bvh"],
         "max_abs_err": hier_err["intersect_bvh"],
         "ms": hier_ms["intersect_bvh", k_main][0],
         "plain_ms": hier_ms["intersect_bvh", k_main][1],
         "bound_ms": k3_b[0], "bound_by": k3_b[1], "library_ms": None},
        {"name": "intersect_cluster", "route": "cuda",
         "source": src + "intersect_cluster.cu",
         "replaces": "pathtracing_spectrum_tpu/ops/intersect_pallas.py:234",
         "launches": cluster_counts["intersect_cluster"],
         "max_abs_err": hier_err["intersect_cluster"],
         "ms": hier_ms["intersect_cluster", k_main][0],
         "plain_ms": hier_ms["intersect_cluster", k_main][1],
         "bound_ms": k3_b[0], "bound_by": k3_b[1], "library_ms": None},
        {"name": "threefry_uniform", "route": "cuda",
         "source": src + "threefry.cu",
         "replaces": "jax.random threefry2x32 (XLA, no Pallas kernel)",
         "launches": main_counts["threefry_uniform"], "max_abs_err": rng_err,
         "ms": rng_ms[RNG_GOLDEN["uniform_shape"]][0],
         "plain_ms": rng_ms[RNG_GOLDEN["uniform_shape"]][1],
         "bound_ms": rng_bound[0], "bound_by": rng_bound[1],
         "library_ms": None},
    ]
    for k in kernels:   # the surface phase's CLI render, previews, picks
        k["launches_surface"] = surf_launches[k["name"]]
        # the multi phase's driven sessions (tiles on 1 and 3, spp on NCCL)
        k["launches_multi"] = multi_launches[k["name"]]
        # the files phase's sessions (textured 1080p from the JPEG, the
        # arithmetic-coded JPEG, the TIFF, the WebP, the SGI and PCX, the
        # CMYK and YCbCr TIFF, the Group 4 and JPEG-in-TIFF, the QOI and
        # DXT1, the ICNS and ICO, the JP2 and J2K, the RLE8 BMP and DIB
        # ICO, the BC6H and BC7 DDS, the FTEX and BLP, the lossy JPEG
        # 2000, the ZSTD and LZMA TIFF, the FITS and PIXAR, the SUN and
        # XPM, and the FLC and PhotoCD maps, the natively parsed 52k
        # terrain)
        k["launches_files"] = files_launches[k["name"]]
    finish(torch)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile(torch, sess, ms_per_sample: float, path: str) -> None:
    """Kernel time by name over 4 more samples of the session. The device's
    busy share is that kernel time per sample over ``ms_per_sample``, the
    unprofiled time of a sample (the profiler's own overhead stretches the
    host side of the profiled run); launches are counted per bounce
    iteration of one wavefront (of one chunk, in a chunked session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    n = 4
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        sess.step(n, readback=False)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    say("profile", path=path, samples=n, kernel_ms_per_sample=busy_ms,
        launches_per_bounce=launches / (2 * sess.scene.trace_depth
                                        * sess.chunks),
        device_busy_pct=100.0 * busy_ms / ms_per_sample)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        name = e.key.replace("void ", "").replace("at::native::", "")
        say("profile", path=path, kernel=repr(name[:90]),
            calls_per_sample=e.count / n,
            ms_per_sample=e.self_device_time_total / 1e3 / n)


if __name__ == "__main__":
    sys.exit(main())
