"""Command-line interface of the port (``python -m
pathtracing_spectrum_tpu_torch``), the JAX package's ``cli.py`` driving the
port's ``RenderSession`` on the card.

Commands:
  render     progressive render of a .pts scene -> spectral txt (+ PNGs)
  info       scene summary (waves, materials, objects, triangles)
  peek       resolution-only scene peek (GetResolutionFromSceneFile parity)
  new        write an empty versioned scene file
  preview    headlight preview PNG through the closest-hit kernel
  import     validate/convert spectral txt inputs (waves / materials)
  bench      the port's benchmark (not ported yet: ROADMAP Queue 1 item 5)
  shell      interactive scene-editing shell (the GUI edit loop, headless)

``render``, ``preview`` and ``shell`` run on ``--device`` (``cuda`` unless
asked for ``cpu``); ``render --shard tiles|spp`` renders on a mesh of the
``--device``'s cards (every card for ``cuda``, one device otherwise).
``--profile DIR`` writes a ``torch.profiler`` Chrome trace,
``DIR/trace.json``. Images (``--png``, ``--png-srgb``, ``--live-out``,
``preview --out``) are written by ``utils/image.py::write_image`` in the
format their extension names, as the JAX package's ``PIL.Image.save``
picks it (``view.jpg`` is a JPEG; an unknown extension raises
``ValueError``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .device import DEFAULT_DEVICE


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracing_spectrum_tpu_torch",
        description="spectral path tracer, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="progressive render of a .pts scene")
    r.add_argument("scene", help="scene file (.pts)")
    r.add_argument("--spp", type=int, default=64,
                   help="target samples per pixel (0..65535)")
    r.add_argument("--out", default=None,
                   help="spectral txt output path (default: timestamped)")
    r.add_argument("--png", default=None,
                   help="PNG path prefix (writes one per wave channel)")
    r.add_argument("--channel", type=int, default=-1,
                   help="single channel PNG instead of all")
    r.add_argument("--png-srgb", default=None, metavar="PATH",
                   help="CIE XYZ->sRGB color PNG (visible-range scenes; "
                        "thermal-IR wavenumbers map to black)")
    r.add_argument("--backend", default="auto",
                   choices=["auto", "dense", "dense_pallas", "bvh",
                            "shortlist", "worklist", "cluster", "hier"])
    r.add_argument("--depth", type=int, default=None,
                   help="override trace depth (1..10)")
    r.add_argument("--res", default=None, help="override resolution WxH")
    r.add_argument("--viewport", default=None, metavar="WxH",
                   help="viewport size; scenes saved with autoRes derive the "
                        "render resolution from it (main.cpp:3271-3283)")
    r.add_argument("--live", type=int, default=0, metavar="N",
                   help="refresh a live PNG of the running mean every N "
                        "samples (main.cpp:3437-3453); 0 = off")
    r.add_argument("--live-out", default=None, metavar="PATH",
                   help="live PNG path (default: <out>_live.png)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--jitter", action="store_true",
                   help="sub-pixel anti-aliasing (off = reference parity)")
    r.add_argument("--dispersion", action="store_true",
                   help="hero-wavelength dispersion (per-wavelength IOR)")
    r.add_argument("--hero", action="store_true",
                   help="hero-wavelength estimator with unchanged "
                        "reference physics (glass stays at IOR 1.5)")
    r.add_argument("--chunks", type=int, default=1,
                   help="trace each sample as N sequential sub-wavefronts "
                        "(bounds the device working set)")
    r.add_argument("--batch", type=int, default=8,
                   help="samples per render_samples call")
    r.add_argument("--checkpoint", default=None,
                   help="write accumulator checkpoint here when done")
    r.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N samples (preemption safety)")
    r.add_argument("--resume", default=None,
                   help="resume accumulator from checkpoint")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "to DIR/trace.json")
    r.add_argument("--redirect", action="append", default=[],
                   metavar="IDX=PATH",
                   help="redirect missing OBJ path for object IDX")
    r.add_argument("--shard", default="none",
                   choices=["none", "tiles", "spp"],
                   help="multi-device strategy: pixel tiles or "
                        "samples per pixel over the --device's cards")
    r.add_argument("--ascii", action="store_true",
                   help="print an ASCII preview when done")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to render on (default: cuda)")

    i = sub.add_parser("info", help="scene summary")
    i.add_argument("scene")

    pk = sub.add_parser("peek", help="print scene resolution only")
    pk.add_argument("scene")

    n = sub.add_parser("new", help="write an empty scene file")
    n.add_argument("scene")

    pv = sub.add_parser("preview", help="headlight raster-style preview PNG")
    pv.add_argument("scene")
    pv.add_argument("--out", default="preview.png")
    pv.add_argument("--res", default=None, help="override resolution WxH")
    pv.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to trace on (default: cuda)")

    imp = sub.add_parser("import", help="validate spectral txt inputs, "
                         "optionally applying them to a scene file")
    imp.add_argument("kind", choices=["waves", "materials"])
    imp.add_argument("path")
    imp.add_argument("--n-waves", type=int, default=0,
                     help="wave count (required for materials without "
                          "--apply)")
    imp.add_argument("--apply", default=None, metavar="SCENE",
                     help="apply the import to this .pts scene "
                          "(LoadSpectrumWaves/LoadSpectrumMaterials "
                          "semantics, main.cpp:217-338)")
    imp.add_argument("--out", default=None, metavar="SCENE",
                     help="write the updated scene here (default: "
                          "overwrite --apply in place)")

    sub.add_parser("bench", help="the port's benchmark (not ported yet)")

    sh = sub.add_parser("shell", help="interactive scene-editing shell "
                        "(the GUI edit loop, headless)")
    sh.add_argument("scene", nargs="?", default=None,
                    help="scene file to open at startup")
    sh.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to render on (default: cuda)")
    return p


def _parse_res(spec: str):
    w, h = spec.lower().split("x")
    return int(w), int(h)


def _sharding(shard: str, device: str):
    """The strategy of ``--shard`` on a mesh of ``device``'s cards: every
    card for ``cuda`` without an index, else the one device named."""
    if shard == "none":
        return None
    from .device import resolve_device
    from .parallel import SppAllreduce, TileSharding, make_mesh
    dev = resolve_device(device)
    mesh = make_mesh() if dev.type == "cuda" and dev.index is None \
        else make_mesh([dev])
    return TileSharding(mesh) if shard == "tiles" else SppAllreduce(mesh)


def _profiler(device, trace_dir: str):
    """A started ``torch.profiler`` recording the host and, on a CUDA
    device, the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    return prof


def cmd_render(args) -> int:
    from . import viewer
    from .render import RenderSession
    from .utils import scene_io, spectral_io
    from .utils.image import write_image

    redirects = {}
    for item in args.redirect:
        idx, _, path = item.partition("=")
        redirects[int(idx)] = path

    refs = scene_io.scan_scene_objects(args.scene)
    missing = [(i, r) for i, r in enumerate(refs)
               if not r.exists and i not in redirects]
    if missing:
        for i, r in missing:
            print(f"missing object {i}: {r.path}  "
                  f"(use --redirect {i}=NEWPATH)", file=sys.stderr)
        return 2

    scene = scene_io.load_scene(args.scene, redirects=redirects)
    if args.depth is not None:
        scene.trace_depth = max(1, min(10, args.depth))
    resolution = _parse_res(args.res) if args.res else None
    if resolution is None and scene.auto_res and args.viewport:
        # autoRes scenes derive the render size from the viewport, like the
        # reference's Display() does each frame (main.cpp:3271-3283)
        resolution = _parse_res(args.viewport)

    session = RenderSession(
        scene, device=args.device, backend=args.backend, seed=args.seed,
        jitter=args.jitter, resolution=resolution,
        sharding=_sharding(args.shard, args.device),
        dispersion=(True if args.dispersion
                    else "hero" if args.hero else False),
        chunks=args.chunks)
    if args.resume:
        session.start()
        session.load_checkpoint(args.resume)
        session.resume()

    target = max(0, min(args.spp, 65535))
    session.start()
    prof = _profiler(session.device, args.profile) if args.profile else None
    live_path = None
    live_next = 0
    if args.live > 0:
        out_guess = args.out or spectral_io.default_export_name(args.scene)
        live_path = args.live_out or f"{out_guess}_live.png"
        live_next = args.live
    try:
        last_ck = session.samples
        while session.samples < target:
            n = min(args.batch, target - session.samples)
            if live_path:
                # land exactly on the next refresh boundary
                n = min(n, max(live_next - session.samples, 1))
            session.step(n, readback=False)
            if live_path and session.samples >= live_next:
                viewer.save_png(session.result(), max(args.channel, 0),
                                live_path)
                if args.png_srgb:
                    # device sRGB epilogue: only uint8 is read back
                    write_image(args.png_srgb, session.result_srgb())
                if args.ascii:
                    print("\n" + viewer.ascii_preview(session.result(),
                                                      max(args.channel, 0)))
                live_next += args.live
            if (args.checkpoint and args.checkpoint_every
                    and session.samples - last_ck >= args.checkpoint_every):
                session.save_checkpoint(args.checkpoint)
                last_ck = session.samples
            if not args.quiet:
                st = session.stats()
                print(f"\r{st['samples']}/{target} spp  "
                      f"{st['avg_time_per_sample_s']*1000:.1f} ms/sample  "
                      f"{st['mrays_per_s']:.1f} Mray/s", end="", flush=True)
    finally:
        if prof is not None:
            prof.stop()
            trace = os.path.join(args.profile, "trace.json")
            prof.export_chrome_trace(trace)
            print(f"\nprofile trace: {trace}")
    if not args.quiet:
        print()
    session.pause()

    img = session.result()
    out_path = args.out or spectral_io.default_export_name(args.scene)
    spectral_io.export_spectrum(out_path, img)
    print(f"exported spectra: {out_path}")

    if args.png:
        if args.channel >= 0:
            viewer.save_png(img, args.channel, f"{args.png}_ch{args.channel}.png")
            print(f"wrote {args.png}_ch{args.channel}.png")
        else:
            for p in viewer.save_all_channels_png(img, args.png):
                print(f"wrote {p}")
    if args.png_srgb:
        write_image(args.png_srgb, session.result_srgb())
        print(f"wrote {args.png_srgb}")
    if args.checkpoint:
        session.save_checkpoint(args.checkpoint)
        print(f"checkpoint: {args.checkpoint}")
    if args.ascii:
        print(viewer.ascii_preview(img, max(args.channel, 0)))

    st = session.stats()
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in st.items()}))
    return 0


def cmd_info(args) -> int:
    from .utils import scene_io

    scene = scene_io.load_scene(args.scene)
    print(f"scene: {args.scene}")
    print(f"wavelengths ({len(scene.wavelengths)}): {scene.wavelengths}")
    print(f"spectrum materials ({len(scene.spectrum_materials)}):")
    for m in scene.spectrum_materials:
        print(f"  {m.name}: {m.emissivity}")
    print(f"sky: material {scene.sky_material_id}, "
          f"{scene.sky_temperature} degC")
    print(f"trace depth: {scene.trace_depth}")
    print(f"resolution: {scene.resolution[0]}x{scene.resolution[1]}"
          f" (auto={scene.auto_res})")
    print(f"camera: pos {scene.camera_position.tolist()}, "
          f"rot {scene.camera_rotation.tolist()} deg")
    print(f"objects ({len(scene.objects)}):")
    for i, o in enumerate(scene.objects):
        print(f"  [{i}] {o.name} <- {o.filename}")
        print(f"      loc {o.location.tolist()} rot {o.rotation.tolist()} "
              f"scale {o.scale.tolist()}")
        for j, el in enumerate(o.elements):
            m = el.material
            print(f"      ({j}) {el.name}: type={m.type.name} "
                  f"specmat={m.spectrum_mat_id} T={m.temperature}C "
                  f"rough={m.roughness}")
    print(f"triangles: {scene.triangle_count()}")
    return 0


def cmd_peek(args) -> int:
    from .utils import scene_io

    res = scene_io.get_resolution_from_scene_file(args.scene)
    if res is None:
        print("unreadable scene file", file=sys.stderr)
        return 1
    print(f"{res[0]}x{res[1]}")
    return 0


def cmd_new(args) -> int:
    from .scene import Scene
    from .utils import scene_io

    scene_io.save_scene(Scene(), args.scene)
    print(f"wrote {args.scene}")
    return 0


def cmd_preview(args) -> int:
    from .preview import preview_render
    from .utils import scene_io
    from .utils.image import write_image

    scene = scene_io.load_scene(args.scene)
    w, h = _parse_res(args.res) if args.res else scene.resolution
    write_image(args.out, preview_render(scene, w, h, device=args.device))
    print(f"wrote {args.out}")
    return 0


def cmd_import(args) -> int:
    from .utils import scene_io, spectral_io

    scene = scene_io.load_scene(args.apply) if args.apply else None
    if args.kind == "waves":
        waves = spectral_io.load_spectrum_waves(args.path)
        print(f"{len(waves)} wavelengths: {waves}")
        if scene is not None:
            scene.import_waves(waves)
            print("material emissivity curves reset "
                  "(LoadSpectrumWaves semantics, main.cpp:229-260)")
    else:
        n_waves = (len(scene.wavelengths) if scene is not None
                   else args.n_waves)
        if n_waves <= 0:
            print("--n-waves (or --apply) required for materials",
                  file=sys.stderr)
            return 2
        mats = spectral_io.load_spectrum_materials(args.path, n_waves)
        for m in mats:
            print(f"{m.name}: {m.emissivity}")
        if scene is not None:
            scene.import_spectrum_materials(mats)
            print("library replaced; old element references cleared "
                  "(LoadSpectrumMaterials semantics, main.cpp:270-338)")

    if scene is not None:
        out = args.out or args.apply
        scene_io.save_scene(scene, out)
        print(f"wrote {out}")
    return 0


def cmd_bench(args) -> int:
    raise NotImplementedError(
        "the port's benchmark is not written yet (ROADMAP Queue 1 item 5); "
        "bench.py measures the JAX package only")


def cmd_shell(args) -> int:
    from .shell import run_shell
    return run_shell(args.scene, device=args.device)


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    return {
        "render": cmd_render,
        "info": cmd_info,
        "peek": cmd_peek,
        "new": cmd_new,
        "preview": cmd_preview,
        "import": cmd_import,
        "bench": cmd_bench,
        "shell": cmd_shell,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
