"""Raster-preview analog: headlight-shaded preview render and picking (port
of ``pathtracing_spectrum_tpu/preview.py``).

The reference's interactive previewer draws the scene with a two-pass GL
pipeline (shaders.h:54-125): pass 0 shades with a headlight diffuse term,
pass 1 writes (objectId, elementId) into an attachment that mouse picking
reads back (main.cpp:3666-3691). Per element the shade colour is the
material baseColor, overridden by the highlight colour when the element is
highlighted, else the selection colour when its object is selected
(main.cpp:3333-3338; defaults at main.cpp:136-138). Here one primary
intersection pass through ``engine.make_intersector(scene_data, "auto")``
gives

* :func:`preview_render` — a grey headlight shading, or an RGB image with
  the reference's tinting when ``rgb=True``, and
* :func:`pick` — the (object, element) ids under a pixel,

so on the card the preview and the pick run K1 at up to 512 triangles and
K3 above, and on the CPU their plain versions: what you pick is what you
trace. Face normals and materials of the hits are gathered with plain
indexing (a miss has idx 0, so the gather stays in range).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .engine import make_intersector
from .models.camera import camera_rays, tile_order
from .scene import Scene, SceneData

_AMBIENT = 0.3  # shading floor so unlit faces stay visible (ours, not ref)

# Reference default preview colors (main.cpp:136-138).
HIGHLIGHT_COLOR = (0.9, 0.9, 0.1)
SELECTION_COLOR = (0.1, 0.7, 0.9)
BG_COLOR = (0.0, 0.0, 0.0)


def _element_table(scene: Scene) -> np.ndarray:
    """[M, 2] (object_id, element_id) per flat material index."""
    rows = [(oi, ei) for oi, obj in enumerate(scene.objects)
            for ei in range(len(obj.elements))]
    return np.asarray(rows or [(-1, -1)], np.int32)


def _tint_table(scene: Scene, highlight_color, selection_color) -> np.ndarray:
    """[M, 3] per-material shade colour, with the reference's precedence:
    element highlight over object selection over baseColor
    (main.cpp:3333-3338)."""
    rows = []
    for obj in scene.objects:
        for el in obj.elements:
            if el.highlight:
                rows.append(highlight_color)
            elif obj.is_selected:
                rows.append(selection_color)
            else:
                rows.append(tuple(el.material.base_color))
    return np.asarray(rows or [(0.0, 0.0, 0.0)], np.float32)


def _planes(ro: torch.Tensor, rd: torch.Tensor):
    return [ro[:, k].contiguous() for k in range(3)] + \
        [rd[:, k].contiguous() for k in range(3)]


def _primary_pass(scene: Scene, scene_data: Optional[SceneData], width: int,
                  height: int, tint: np.ndarray, bg, device) -> torch.Tensor:
    """One primary intersection and headlight shade of every pixel, in
    32x32 tile order on the device; returns uint8 [N, 3] on the host in
    scanline order."""
    device = resolve_device(device)
    data = scene_data if scene_data is not None else scene.compile(device)
    # the rays are made on the host, as the session makes them, so every
    # device traces the same float32 rays; tile order keeps a kernel
    # block's rays on one screen region
    ro, rd = camera_rays(scene.camera(), width, height, "cpu")
    perm, inv = tile_order(width, height)
    perm_t = torch.from_numpy(perm.astype(np.int64))
    ro, rd = ro[perm_t].to(device), rd[perm_t].to(device)
    intersect, _ = make_intersector(data, "auto")
    hit, _, idx, _, _ = intersect(*_planes(ro, rd))
    idx = idx.long()
    n = data.tri_face_n[idx]
    # headlight: l = -view direction; the flipped normal makes dot >= 0
    shade = torch.clamp(torch.abs((n * rd).sum(dim=-1)), min=_AMBIENT)
    f32 = dict(dtype=torch.float32, device=device)
    color = torch.tensor(tint, **f32)[data.tri_material[idx].long()]
    img = torch.where(hit[:, None], color * shade[:, None],
                      torch.tensor(np.asarray(bg, np.float32), **f32)[None])
    img = (img * 255.0).clamp(0.0, 255.0).to(torch.uint8)
    # back to scanline order on the device, then one uint8 readback
    return img.index_select(
        0, torch.from_numpy(inv.astype(np.int64)).to(device)).cpu()


def preview_render(scene: Scene, width: int, height: int,
                   scene_data: SceneData = None, rgb: bool = False,
                   highlight_color=HIGHLIGHT_COLOR,
                   selection_color=SELECTION_COLOR,
                   bg_color=BG_COLOR,
                   device: "torch.device | str" = DEFAULT_DEVICE
                   ) -> np.ndarray:
    """Headlight-diffuse preview image on ``device`` (the card unless the
    caller asks for the CPU; ``scene_data``, when given, must lie there).

    ``rgb=False``: uint8 [H, W] grey (shading only, ignores tint).
    ``rgb=True``: uint8 [H, W, 3] with the reference's per-element
    baseColor/highlight/selection colouring (main.cpp:3333-3338).
    """
    if rgb:
        tint = _tint_table(scene, highlight_color, selection_color)
        img = _primary_pass(scene, scene_data, width, height, tint,
                            bg_color, device)
        return img.numpy().reshape(height, width, 3)
    tint = np.ones((_element_table(scene).shape[0], 3), np.float32)
    img = _primary_pass(scene, scene_data, width, height, tint,
                        (0.0, 0.0, 0.0), device)
    return img[:, 0].numpy().reshape(height, width)


def pick(scene: Scene, width: int, height: int, x: int, y: int,
         scene_data: SceneData = None,
         device: "torch.device | str" = DEFAULT_DEVICE) -> Tuple[int, int]:
    """(object_id, element_id) under pixel (x, y); (-1, -1) on a miss.

    The reference reads its pick attachment back (ids offset by one so 0
    is the background, main.cpp:3682-3691); here the one ray of that pixel
    is traced, through the same closest-hit kernel as the preview.
    """
    device = resolve_device(device)
    data = scene_data if scene_data is not None else scene.compile(device)
    ro, rd = camera_rays(scene.camera(), width, height, "cpu")
    pixel = y * width + x
    ro1 = ro[pixel:pixel + 1].to(device)
    rd1 = rd[pixel:pixel + 1].to(device)
    intersect, _ = make_intersector(data, "auto")
    hit, _, idx, _, _ = intersect(*_planes(ro1, rd1))
    if not bool(hit[0]):
        return (-1, -1)
    mat = int(data.tri_material[idx[0].long()])
    table = _element_table(scene)
    if mat >= table.shape[0]:
        return (-1, -1)
    return int(table[mat, 0]), int(table[mat, 1])
