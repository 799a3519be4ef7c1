"""Interactive editing shell — the reference GUI's edit loop, headless
(port of ``pathtracing_spectrum_tpu/shell.py``, every command).

The reference edits transforms, materials, waves and the sky live in ImGui
panels (main.cpp:1701-2692) with unsaved-changes tracking and a save-confirm
dialog on open/new/exit (main.cpp:3107-3174). This module re-creates that
*workflow* as a line-oriented REPL over the same Scene/RenderSession API the
GUI panels would call:

* every mutation goes through the Scene setters (so ``Scene.modified`` and
  the scene version advance exactly as the GUI's edits would);
* a render can run in the background (``RenderSession.start_async`` — the
  reference's GUI-thread/tracer-thread split) while the scene stays
  editable; ``restart`` re-syncs edits into the running render just as the
  reference re-syncs on every start/restart edge (main.cpp:4010-4027);
* ``open``/``new``/``quit`` ask before discarding unsaved changes, mirroring
  the save-changes dialog; pass a stream to the constructor to script it.

Renders and previews run on the shell's ``device``, the card unless it
is built with ``device="cpu"``; images are written by
``utils/image.py::write_image`` (grey or RGB) in the format their
extension names, as the JAX shell's ``PIL.Image.save`` does, not PIL.

Run via ``python -m pathtracing_spectrum_tpu_torch shell [scene.pts]
[--device cpu]``.
"""

from __future__ import annotations

import cmd
import os
import shlex
import sys
from typing import Optional

from .device import DEFAULT_DEVICE, resolve_device
from .models.materials import MaterialType
from .scene import Scene


def _f3(args, start=0):
    return [float(a) for a in args[start:start + 3]]


class SpectrumShell(cmd.Cmd):
    intro = ("pathtracing_spectrum_tpu_torch interactive shell — 'help' "
             "for commands, 'quit' to exit.")
    prompt = "pts> "

    def __init__(self, scene_path: Optional[str] = None, stdin=None,
                 stdout=None, device: "torch.device | str" = DEFAULT_DEVICE):
        super().__init__(stdin=stdin, stdout=stdout)
        self.device = resolve_device(device)
        if stdin is not None:
            self.use_rawinput = False
        self.scene = Scene()
        self.path: Optional[str] = None
        self.session = None
        self._autopreview: Optional[str] = None
        self._view_key = None
        if scene_path:
            self._open(scene_path)

    # -- helpers -------------------------------------------------------------
    def _say(self, msg: str) -> None:
        self.stdout.write(msg + "\n")

    def _ask(self, prompt: str) -> str:
        """Read one confirmation line through the shell's own stdin so
        scripted sessions can answer (the GUI's modal dialog equivalent)."""
        self.stdout.write(prompt)
        self.stdout.flush()
        if self.use_rawinput:
            try:
                return input()
            except EOFError:
                return ""
        line = self.stdin.readline()
        return line.strip() if line else ""

    def _confirm_discard(self) -> bool:
        """Save-changes dialog (main.cpp:3107-3174): yes = save first,
        no = discard, cancel = abort the operation."""
        if not self.scene.modified:
            return True
        ans = self._ask("scene has unsaved changes — save first? "
                        "[y]es / [n]o / [c]ancel: ").lower()
        if ans.startswith("y"):
            return self._save(None)
        if ans.startswith("n"):
            return True
        self._say("cancelled")
        return False

    def _open(self, path: str) -> None:
        from .utils import scene_io
        self.scene = scene_io.load_scene(path)
        self.path = path
        self.session = None
        self._say(f"opened {path}: {len(self.scene.objects)} objects, "
                  f"{self.scene.triangle_count()} triangles")

    def _save(self, path: Optional[str]) -> bool:
        from .utils import scene_io
        path = path or self.path
        if not path:
            self._say("no path — use: save <file.pts>")
            return False
        scene_io.save_scene(self.scene, path)
        self.path = path
        self.scene.modified = False
        self._say(f"saved {path}")
        return True

    def _get_session(self):
        if self.session is None:
            from .render import RenderSession
            self.session = RenderSession(self.scene, self.device)
        return self.session

    def _obj(self, idx: str):
        i = int(idx)
        if not 0 <= i < len(self.scene.objects):
            raise IndexError(f"no object {i}")
        return self.scene.objects[i]

    # -- file ----------------------------------------------------------------
    def do_open(self, arg):
        """open <scene.pts> — load a scene (asks about unsaved changes)"""
        if not self._confirm_discard():
            return
        self._open(shlex.split(arg)[0])

    def do_new(self, arg):
        """new — reset to an empty scene (asks about unsaved changes)"""
        if not self._confirm_discard():
            return
        self.scene = Scene()
        self.path = None
        self.session = None
        self._say("new scene")

    def do_save(self, arg):
        """save [path] — write the scene (.pts, byte-compatible format)"""
        parts = shlex.split(arg)
        self._save(parts[0] if parts else None)

    # -- inspect -------------------------------------------------------------
    def do_info(self, arg):
        """info — scene summary (waves, materials, objects, camera)"""
        sc = self.scene
        self._say(f"path: {self.path or '(unsaved)'}"
                  f"{' *modified*' if sc.modified else ''}")
        self._say(f"wavelengths ({len(sc.wavelengths)}): {sc.wavelengths}")
        self._say(f"spectrum materials: "
                  f"{[m.name for m in sc.spectrum_materials]}")
        self._say(f"sky: material {sc.sky_material_id}, "
                  f"{sc.sky_temperature} degC")
        self._say(f"depth {sc.trace_depth}, resolution "
                  f"{sc.resolution[0]}x{sc.resolution[1]} "
                  f"(auto={sc.auto_res})")
        self._say(f"camera pos {sc.camera_position.tolist()} "
                  f"rot {sc.camera_rotation.tolist()} fovy {sc.camera_fovy}")
        for i, o in enumerate(sc.objects):
            self._say(f"[{i}] {o.name} <- {o.filename}  "
                      f"loc {o.location.tolist()} rot {o.rotation.tolist()} "
                      f"scale {o.scale.tolist()}")
            for j, el in enumerate(o.elements):
                m = el.material
                self._say(f"    ({j}) {el.name}: {m.type.name} "
                          f"specmat={m.spectrum_mat_id} T={m.temperature}C "
                          f"rough={m.roughness} ior={m.ior}")

    # -- objects -------------------------------------------------------------
    def do_load(self, arg):
        """load <file.obj> [name] — add an object"""
        parts = shlex.split(arg)
        before = self.scene.triangle_count()
        obj = self.scene.load_object(parts[0],
                                     name=parts[1] if len(parts) > 1 else None)
        self._say(f"[{len(self.scene.objects) - 1}] {obj.name}: "
                  f"{self.scene.triangle_count() - before} tris, "
                  f"{len(obj.elements)} elements")

    def do_delete(self, arg):
        """delete <idx> — remove an object"""
        i = int(shlex.split(arg)[0])
        self._obj(str(i))
        for j in range(len(self.scene.objects)):
            self.scene.select_object(j, j == i)
        self.scene.delete_selected_objects()
        self._say(f"deleted object {i}")

    def do_replace(self, arg):
        """replace <idx> <file.obj> — swap an object's mesh, keep transform"""
        parts = shlex.split(arg)
        self.scene.replace_object(int(parts[0]), parts[1])
        self._say("replaced")

    def do_rename(self, arg):
        """rename <idx> <name> | rename <idx> <el> <name>"""
        parts = shlex.split(arg)
        if len(parts) == 2:
            self.scene.rename_object(int(parts[0]), parts[1])
        else:
            self.scene.rename_element(int(parts[0]), int(parts[1]), parts[2])
        self._say("renamed")

    # -- transforms (GUI panel main.cpp:1701-1860) ---------------------------
    def do_move(self, arg):
        """move <idx> <x y z> — set object location"""
        parts = shlex.split(arg)
        self._obj(parts[0]).set_location(_f3(parts, 1))
        self.scene.modified = True
        self.scene.version += 1

    def do_rotate(self, arg):
        """rotate <idx> <rx ry rz> — set rotation (degrees, glm order)"""
        parts = shlex.split(arg)
        self._obj(parts[0]).set_rotation(_f3(parts, 1))
        self.scene.modified = True
        self.scene.version += 1

    def do_scale(self, arg):
        """scale <idx> <sx sy sz> [nolock] — set scale (lock cascade unless
        'nolock', previewer.cpp scale-lock parity)"""
        parts = shlex.split(arg)
        lock = not (len(parts) > 4 and parts[4] == "nolock")
        self._obj(parts[0]).set_scale(_f3(parts, 1), respect_lock=lock)
        self.scene.modified = True
        self.scene.version += 1

    # -- camera / globals ----------------------------------------------------
    def do_camera(self, arg):
        """camera <x y z> [rx ry rz] — set camera position (+rotation)"""
        parts = shlex.split(arg)
        rot = _f3(parts, 3) if len(parts) >= 6 else None
        self.scene.set_camera(_f3(parts, 0), rot)

    def do_fovy(self, arg):
        """fovy <deg> — vertical field of view"""
        self.scene.camera_fovy = float(shlex.split(arg)[0])
        self.scene.modified = True
        self.scene.version += 1

    def do_depth(self, arg):
        """depth <n> — trace depth (1..10, reference GUI range)"""
        self.scene.trace_depth = max(1, min(10, int(shlex.split(arg)[0])))
        self.scene.modified = True
        self.scene.version += 1

    def do_res(self, arg):
        """res <WxH> — render resolution"""
        w, h = shlex.split(arg)[0].lower().split("x")
        self.scene.resolution = (int(w), int(h))
        self.scene.modified = True
        self.scene.version += 1

    def do_waves(self, arg):
        """waves <w1 w2 ...> | waves import <file.txt> — set wavenumbers.
        Both reset every spectrum material's emissivity curve to zeros of
        the new length (LoadSpectrumWaves semantics, main.cpp:229-260)."""
        from .utils import spectral_io
        parts = shlex.split(arg)
        if parts and parts[0] == "import":
            self.scene.import_waves(spectral_io.load_spectrum_waves(parts[1]))
        else:
            self.scene.import_waves([float(p) for p in parts])
        self._say(f"{len(self.scene.wavelengths)} waves "
                  f"(material curves reset)")

    def do_specmat(self, arg):
        """specmat — spectrum-material library CRUD (reference left bar,
        main.cpp:2461-2692):
          specmat                       list the library
          specmat add [name] [e1 e2 ..] add (default zeros per wave)
          specmat del <id> [id ...]     delete + fix references
          specmat rename <id> <name>    rename
          specmat edit <id> <e1 e2 ...> replace the emissivity curve
          specmat import <file.txt>     replace library from txt
                                        (LoadSpectrumMaterials)"""
        parts = shlex.split(arg)
        sc = self.scene
        if not parts:
            for i, m in enumerate(sc.spectrum_materials):
                self._say(f"[{i}] {m.name}: {m.emissivity}")
            if not sc.spectrum_materials:
                self._say("(no spectrum materials)")
            return
        op = parts[0]
        if op == "add":
            name = parts[1] if len(parts) > 1 else None
            eps = [float(p) for p in parts[2:]] if len(parts) > 2 else None
            if eps is not None:
                nw = len(sc.wavelengths)
                eps = (eps + [0.0] * nw)[:nw]
            i = sc.add_spectrum_material(name, eps)
            self._say(f"[{i}] {sc.spectrum_materials[i].name}")
        elif op in ("del", "delete"):
            sc.delete_spectrum_materials(int(p) for p in parts[1:])
            self._say(f"{len(sc.spectrum_materials)} materials left")
        elif op == "rename":
            sc.rename_spectrum_material(int(parts[1]), parts[2])
            self._say("renamed")
        elif op == "edit":
            sc.set_spectrum_emissivity(int(parts[1]),
                                       [float(p) for p in parts[2:]])
            self._say(f"[{parts[1]}] "
                      f"{sc.spectrum_materials[int(parts[1])].emissivity}")
        elif op == "import":
            from .utils import spectral_io
            mats = spectral_io.load_spectrum_materials(
                parts[1], len(sc.wavelengths))
            sc.import_spectrum_materials(mats)
            self._say(f"imported {len(mats)} materials "
                      f"(old element references cleared)")
        else:
            self._say(f"unknown specmat op: {op}")

    def do_tex(self, arg):
        """tex normal|rough|tempdata <obj> <el> <path|-> — bind (or with
        '-' unbind) a per-element texture / ASCII temperature grid
        (reference Set*TextureForElement, pathtracer.cpp:152-198)."""
        parts = shlex.split(arg)
        kind, o, e = parts[0], int(parts[1]), int(parts[2])
        path = "" if parts[3] == "-" else parts[3]
        if kind == "normal":
            self.scene.set_normal_texture(o, e, path)
        elif kind in ("rough", "roughness"):
            self.scene.set_roughness_texture(o, e, path)
        elif kind in ("tempdata", "temp"):
            self.scene.set_temperature_data(o, e, path)
        else:
            self._say(f"unknown texture kind: {kind} "
                      f"(normal|rough|tempdata)")
            return
        self._say(f"{kind} {'unbound' if not path else 'bound'} "
                  f"on object {o} element {e}")

    def do_select(self, arg):
        """select <obj> [on|off] — object selection (previewer.cpp:862-867);
        selected objects tint cyan in previews"""
        parts = shlex.split(arg)
        on = len(parts) < 2 or parts[1] != "off"
        self.scene.select_object(int(parts[0]), on)
        self._say(f"object {parts[0]} "
                  f"{'selected' if on else 'deselected'}")

    def do_highlight(self, arg):
        """highlight <obj> <el> [on|off] — element highlight flag
        (previewer.cpp:842-859); highlighted elements tint yellow"""
        parts = shlex.split(arg)
        on = len(parts) < 3 or parts[2] != "off"
        self.scene.set_highlight(int(parts[0]), int(parts[1]), on)
        self._say(f"highlight {'on' if on else 'off'}")

    def do_sky(self, arg):
        """sky <spectrum_mat_id> <tempC> — sky material + temperature"""
        parts = shlex.split(arg)
        self.scene.sky_material_id = int(parts[0])
        self.scene.sky_temperature = float(parts[1])
        self.scene.modified = True
        self.scene.version += 1

    def do_mat(self, arg):
        """mat <obj> <el> key=value... — edit a material in place.
        Keys: type (DIFFUSE/SPECULAR/GLOSSY/GLASS), temp, rough, ior,
        specmat, dispersion_b. Example: mat 0 2 type=GLASS ior=1.5"""
        import dataclasses
        parts = shlex.split(arg)
        o, e = int(parts[0]), int(parts[1])
        m = self.scene.objects[o].elements[e].material
        kw = {}
        for p in parts[2:]:
            k, _, v = p.partition("=")
            if k == "type":
                kw["type"] = MaterialType[v.upper()]
            elif k in ("temp", "temperature"):
                kw["temperature"] = float(v)
            elif k in ("rough", "roughness"):
                kw["roughness"] = float(v)
            elif k == "ior":
                kw["ior"] = float(v)
            elif k in ("specmat", "spectrum_mat_id"):
                kw["spectrum_mat_id"] = int(v)
            elif k == "dispersion_b":
                kw["dispersion_b"] = float(v)
            else:
                self._say(f"unknown key: {k}")
                return
        self.scene.set_material(o, e, dataclasses.replace(m, **kw))
        self._say("material set")

    # -- render control (tracer-thread analogue) -----------------------------
    def do_render(self, arg):
        """render [spp] — start/restart an async render (0 = unbounded)"""
        parts = shlex.split(arg)
        target = int(parts[0]) if parts else 0
        s = self._get_session()
        s.stop()
        s.join(timeout=30)
        s.start_async(target_spp=target)
        self._say(f"rendering (target {target or 'unbounded'} spp) — "
                  f"'status' to watch, 'pause'/'stop' to control")

    def do_pause(self, arg):
        """pause — pause the render, keep the accumulator"""
        if self.session:
            self.session.pause()

    def do_resume(self, arg):
        """resume — continue a paused render"""
        if self.session:
            self.session.resume()

    def do_stop(self, arg):
        """stop — stop the render (next render restarts from scratch)"""
        if self.session:
            self.session.stop()
            self.session.join(timeout=30)

    def do_restart(self, arg):
        """restart — re-sync scene edits and start over (reference
        restart edge, main.cpp:4010-4027)"""
        if self.session:
            with self.session._lock:
                self.session.restart()

    def do_status(self, arg):
        """status — render progress"""
        if not self.session:
            self._say("no render yet")
            return
        st = self.session.stats()
        self._say(f"{st['status']}: {st['samples']} spp, "
                  f"{st['elapsed_s']:.1f}s, {st['mrays_per_s']:.1f} Mray/s, "
                  f"backend {st['backend']}")

    def do_export(self, arg):
        """export [path] — write the current running mean as spectral txt"""
        from .utils import spectral_io
        if not self.session:
            self._say("no render yet")
            return
        path = (shlex.split(arg) or
                [spectral_io.default_export_name(self.path or "scene.pts")])[0]
        with self.session._lock:
            img = self.session.result()
        spectral_io.export_spectrum(path, img)
        self._say(f"exported {path}")

    def do_png(self, arg):
        """png <prefix> [channel] — write PNG(s) of the running mean"""
        from . import viewer
        if not self.session:
            self._say("no render yet")
            return
        parts = shlex.split(arg)
        with self.session._lock:
            img = self.session.result()
        if len(parts) > 1:
            ch = int(parts[1])
            viewer.save_png(img, ch, f"{parts[0]}_ch{ch}.png")
            self._say(f"wrote {parts[0]}_ch{ch}.png")
        else:
            for p in viewer.save_all_channels_png(img, parts[0]):
                self._say(f"wrote {p}")

    def do_preview(self, arg):
        """preview <out.png> [gray] — headlight preview with the
        reference's baseColor/highlight/selection tinting (main.cpp:
        3333-3338); 'gray' for the untinted shading-only view"""
        parts = shlex.split(arg)
        self._write_preview(parts[0], gray=len(parts) > 1
                            and parts[1] == "gray")
        self._say(f"wrote {parts[0]}")

    def _write_preview(self, out: str, gray: bool = False) -> None:
        from .preview import preview_render
        from .utils.image import write_image
        w, h = self.scene.resolution
        write_image(out, preview_render(self.scene, w, h, rgb=not gray,
                                      device=self.device))
        self._view_key = self._view_state()

    # -- autopreview: refresh the preview PNG after each mutating command
    #    (the reference repaints the raster preview every frame while
    #    editing, main.cpp:3290-3356 — this is the headless equivalent) ----
    def do_autopreview(self, arg):
        """autopreview on <out.png> | off — refresh a preview PNG after
        every command that changes the scene, selection or highlights"""
        parts = shlex.split(arg)
        if parts and parts[0] == "on":
            self._autopreview = parts[1] if len(parts) > 1 else "preview.png"
            self._write_preview(self._autopreview)
            self._say(f"autopreview -> {self._autopreview}")
        else:
            self._autopreview = None
            self._say("autopreview off")

    def _view_state(self):
        """Everything the preview image depends on (scene version counts
        geometry/material edits; selection/highlight are view-only flags
        that do not bump it)."""
        return (id(self.scene), self.scene.version,
                tuple((o.is_selected, tuple(el.highlight
                                            for el in o.elements))
                      for o in self.scene.objects))

    def postcmd(self, stop, line):
        if getattr(self, "_autopreview", None):
            if self._view_state() != getattr(self, "_view_key", None):
                try:
                    self._write_preview(self._autopreview)
                    self._say(f"[autopreview] {self._autopreview}")
                except Exception as e:
                    self._say(f"[autopreview] failed: {e}")
        return stop

    # -- exit ----------------------------------------------------------------
    def do_quit(self, arg):
        """quit — exit (asks about unsaved changes)"""
        if not self._confirm_discard():
            return False
        if self.session:
            self.session.stop()
            self.session.join(timeout=30)
        return True

    do_exit = do_quit

    def do_EOF(self, arg):
        self._say("")
        return self.do_quit(arg)

    def default(self, line):
        self._say(f"unknown command: {line.split()[0]} — 'help' lists "
                  f"commands")

    def emptyline(self):
        pass

    def onecmd(self, line):
        try:
            return super().onecmd(line)
        except SystemExit:
            raise
        except Exception as e:  # keep the shell alive on bad input
            self._say(f"error: {type(e).__name__}: {e}")
            return False


def run_shell(scene_path: Optional[str] = None,
              device: "torch.device | str" = DEFAULT_DEVICE) -> int:
    SpectrumShell(scene_path, device=device).cmdloop()
    return 0
