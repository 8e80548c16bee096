"""Benchmark: rays/s on one GPU at 1024², reference world, bench camera.

Measures the XLA engines: the surface-guided differentiable render forward +
backward (seed march + 24-step window, gradient w.r.t. voxel densities and
albedos) for each window accumulator x enumeration, and the full-feature
forward frame (materials + shadows) on the fast and fast+progressive engines.
Each time is the median of warm calls that end in ``block_until_ready``.
Prints exactly one JSON line naming the device; refuses to run without a GPU.

    python bench.py
"""

import json

import jax
import jax.numpy as jnp

from raytracing_test_tpu.config import RenderConfig, WorldConfig
from raytracing_test_tpu.core import flatten
from raytracing_test_tpu.render import diff, fast, progressive
from raytracing_test_tpu.render.camera import Camera, ray_directions
from raytracing_test_tpu.utils import profiling
from raytracing_test_tpu.utils.compile_cache import enable_compile_cache
from raytracing_test_tpu.worldgen import terrain

H = W = 1024
NUM_STEPS = 24  # surface-guided window length
REPS = 5


def main():
    info = profiling.require_gpu()
    enable_compile_cache()
    label = profiling.gpu_label()

    grid, pal = terrain.gen_world_grid(WorldConfig())
    scene = flatten.scene_from_grid(grid, pal)
    albedo, _, _ = flatten.palette_arrays(pal)
    dscene = diff.diff_scene_from_grid(grid, albedo, solid_density=50.0)
    cam = Camera(
        pos=jnp.asarray([100.0, 60.0, 40.0], jnp.float32),
        dir=jnp.asarray([0.55, -0.4, 0.55], jnp.float32),
    )
    dirs = ray_directions(cam, W, H)

    def rays_per_s(fn, *args):
        return H * W / (profiling.median_ms(
            profiling.time_call(jax.jit(fn), *args, reps=REPS)) * 1e-3)

    rates = {}
    for accum in ("scatter", "dedup"):
        for emode in ("scan", "vec"):
            def fwd_bwd(ds, sc, o, d, _a=accum, _e=emode):
                def loss(ds):
                    seed = diff.guided_seed(sc, o, d, image_hw=(H, W))
                    return jnp.mean(diff.render_rays_diff_window(
                        ds, o, d, num_steps=NUM_STEPS, sky=False, start_t=seed,
                        accum=_a, enumerate_mode=_e))

                return jax.grad(loss)(ds)

            rates[f"fwd+bwd[{accum}/{emode}]"] = rays_per_s(
                fwd_bwd, dscene, scene, cam.pos, dirs)

    rcfg = RenderConfig(width=W, height=H)
    rates["fwd[fast]"] = rays_per_s(
        lambda sc, c: fast.render_image_fast(sc, c, rcfg), scene, cam)
    rates["fwd[fast+progressive]"] = rays_per_s(
        lambda sc, c: progressive.render_image_progressive(sc, c, rcfg)[0],
        scene, cam)

    best = max((k for k in rates if k.startswith("fwd+bwd")), key=rates.get)
    print(json.dumps({
        "metric": f"rays/s, {H}x{W} guided-window forward+backward "
                  f"({NUM_STEPS} steps), best variant {best}",
        "value": rates[best],
        "unit": "rays/s",
        "rates": rates,
        "device": info,
        "card": label,
    }))


if __name__ == "__main__":
    main()
