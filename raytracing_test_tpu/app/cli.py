"""Command-line driver: render / animate / edit / fit / probe.

The headless analog of the reference's interactive loop (main.cpp frame loop +
input.cpp handlers). `edit` accepts a command script (or stdin REPL) with the
same verbs the reference binds to keys/mouse: look, move, place, delete,
select, render.

    python -m raytracing_test_tpu.app.cli render --out frame.png
    python -m raytracing_test_tpu.app.cli animate --frames 8 --out-dir anim/
    echo "look 55 -25; place; render out.png" | \
        python -m raytracing_test_tpu.app.cli edit -
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..config import FitConfig, RenderConfig, WorldConfig, replace
from ..utils.log import debug, set_debug_level
from .session import WorldSession


def _save(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)).save(path)
    debug(1, f"wrote {path}")


def _mk_session(args) -> WorldSession:
    from ..config import world_for_size

    wcfg = world_for_size(args.world)
    s = WorldSession(wcfg, use_native=not args.no_native)
    if args.pos:
        s.pos = np.asarray([float(v) for v in args.pos.split(",")], np.float64)
    s.yaw, s.pitch = args.yaw, args.pitch
    return s


def _rcfg(args) -> RenderConfig:
    return RenderConfig(
        width=args.width,
        height=args.height,
        enable_ao=args.ao,
        enable_shadows=not args.no_shadows,
    )


def cmd_render(args) -> None:
    s = _mk_session(args)
    mode = "reference" if args.slow else args.mode
    img = s.render(_rcfg(args), mode=mode)
    _save(img, args.out)


def cmd_animate(args) -> None:
    from ..utils.profiling import FrameStats, trace

    s = _mk_session(args)
    os.makedirs(args.out_dir, exist_ok=True)
    rcfg = _rcfg(args)
    stats = FrameStats()  # the reference's rolling frame average (main.cpp:221)
    with trace(args.trace):
        for i in range(args.frames):
            s.time = i / 10.0  # drives the water surface animation
            s.rotate(args.spin, 0.0)
            stats.start()
            img = s.render(rcfg)
            stats.stop(rays=rcfg.width * rcfg.height)
            _save(img, os.path.join(args.out_dir, f"frame_{i:04d}.png"))
            debug(1, stats.status())


def cmd_edit(args) -> None:
    s = _mk_session(args)
    rcfg = _rcfg(args)
    src = sys.stdin if args.script == "-" else open(args.script)
    text = src.read()
    for raw in text.replace(";", "\n").splitlines():
        parts = raw.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        op, rest = parts[0], parts[1:]
        if op == "look":
            s.yaw, s.pitch = float(rest[0]), float(rest[1])
        elif op == "rotate":
            s.rotate(float(rest[0]), float(rest[1]))
        elif op == "move":
            s.move(*(float(v) for v in rest))
        elif op == "goto":
            s.pos = np.asarray([float(v) for v in rest], np.float64)
        elif op == "select":
            s.selected = int(rest[0]) % len(s.hotbar)
        elif op == "place":
            pos = s.place(int(rest[0]) if rest else None)
            debug(1, f"placed at {pos}")
        elif op == "delete":
            pos = s.delete()
            debug(1, f"deleted {pos}" if pos else "nothing to delete in range")
        elif op == "pick":
            debug(1, f"pick: {s.pick()}")
        elif op == "time":
            s.time = float(rest[0])
        elif op == "render":
            _save(s.render(rcfg), rest[0] if rest else "frame.png")
        elif op == "save":
            from . import checkpoint

            s.sync()
            checkpoint.save_world(rest[0], s.grid, s.palette)
            debug(1, f"world saved to {rest[0]}")
        else:
            debug(0, f"unknown edit command: {op}")


def cmd_fit(args) -> None:
    from . import fit as fitmod

    s = _mk_session(args)
    fcfg = FitConfig(
        views=args.views, steps=args.steps, lr=args.lr, resolution=args.fit_res,
        guided=args.guided, shading=args.shading,
    )
    params, losses = fitmod.fit_world(
        s.scene, s.grid.shape, fcfg, ckpt_path=args.ckpt, batch=args.batch
    )
    debug(0, f"fit done: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if args.out:
        from ..parallel.sharding import params_to_scene
        from ..render.camera import camera_from_yaw_pitch
        from ..render.diff import render_image_diff

        cam = camera_from_yaw_pitch(tuple(s.pos), s.yaw, s.pitch)
        img = np.asarray(
            render_image_diff(params_to_scene(params), cam, _rcfg(args))
        )
        _save(img, args.out)


def cmd_probe(args) -> None:
    from . import debug as dbg

    s = _mk_session(args)
    s.sync()
    ch = dbg.render_debug(s.scene, s.camera(), _rcfg(args))
    out = dbg.probe_pixel(ch, args.row, args.col)
    for k, v in out.items():
        print(f"{k}: {v}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="raytracing_test_tpu")
    p.add_argument("--debug-level", type=int, default=1)
    p.add_argument("--world", type=int, default=200, help="world columns per side")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--pos", type=str, default="")
    p.add_argument("--yaw", type=float, default=45.0)
    p.add_argument("--pitch", type=float, default=25.0)  # positive pitch looks down (ref convention)
    p.add_argument("--ao", action="store_true")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--no-native", action="store_true")
    p.add_argument("--slow", action="store_true", help="use the reference path")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render")
    r.add_argument("--out", default="frame.png")
    r.add_argument(
        "--mode",
        default="fast",
        choices=[
            "fast", "bricks", "reference", "progressive", "spatial", "handoff",
        ],
        help="render path (see app/session.py render)",
    )
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate")
    a.add_argument("--frames", type=int, default=8)
    a.add_argument("--spin", type=float, default=3.0)
    a.add_argument("--out-dir", default="anim")
    a.add_argument("--trace", default=None, help="jax.profiler trace dir")
    a.set_defaults(fn=cmd_animate)

    e = sub.add_parser("edit")
    e.add_argument("script", help="command script path, or - for stdin")
    e.set_defaults(fn=cmd_edit)

    f = sub.add_parser("fit")
    f.add_argument("--views", type=int, default=8)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--lr", type=float, default=0.05)
    f.add_argument("--fit-res", type=int, default=64)
    f.add_argument("--batch", type=int, default=8192)
    f.add_argument("--ckpt", default="")
    f.add_argument(
        "--guided", action="store_true",
        help="surface-guided sampling with occupancy re-thresholding",
    )
    f.add_argument(
        "--shading", action="store_true",
        help="fit face-shaded targets (matches the hard renderer's output)",
    )
    f.add_argument("--out", default="")
    f.set_defaults(fn=cmd_fit)

    pr = sub.add_parser("probe")
    pr.add_argument("--row", type=int, default=0)
    pr.add_argument("--col", type=int, default=0)
    pr.set_defaults(fn=cmd_probe)

    p.add_argument(
        "--platform",
        default=os.environ.get("RTT_PLATFORM", ""),
        help="force a jax platform (e.g. cpu) instead of the default device",
    )
    args = p.parse_args(argv)
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    set_debug_level(args.debug_level)
    args.fn(args)


if __name__ == "__main__":
    main()
