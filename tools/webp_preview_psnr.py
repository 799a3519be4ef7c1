#!/usr/bin/env python3
"""Print the PSNR of the module preview's WebP, computed on the CPU.

``chip_smoke.py``'s ``files`` phase writes the textured sphere scene's
640x360 grey preview through ``python -m pathtracing_spectrum_tpu_torch
preview ... --out v.webp`` on the card, reads the file back with the
port's WebP decoder and holds its PSNR against the grey preview to
``WEBP_PREVIEW_MIN_PSNR``, which is 5 dB below the value this script
prints: the same scene, preview and file made on the CPU. Run from the
repository's root: ``python3 tools/webp_preview_psnr.py``.
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import importlib.util

    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch.preview import preview_render
    from pathtracing_spectrum_tpu_torch.utils import image, scene_io, webp
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with tempfile.TemporaryDirectory() as tmp:
        scene_path = os.path.join(tmp, "textured.pts")
        scene_io.save_scene(smoke.textured_sphere_scene(
            pt, (640, 360), roughness=os.path.join(
                smoke.FILES_DIR, "roughness_2048_deflate.tif")), scene_path)
        grey = preview_render(scene_io.load_scene(scene_path), 640, 360,
                              device="cpu")
        out = os.path.join(tmp, "v.webp")
        image.write_image(out, grey)
        with open(out, "rb") as f:
            view = webp.decode_rgba(f.read())
    psnr = smoke.preview_psnr(view, grey)
    print(f"psnr_db={psnr!r} min_psnr_db_in_chip_smoke="
          f"{smoke.WEBP_PREVIEW_MIN_PSNR!r} cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
