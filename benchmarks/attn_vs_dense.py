# run from the repo root
import time, jax, jax.numpy as jnp, numpy as np
from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M
from vitrs_tpu.ops import optimizer as opt
from vitrs_tpu.utils import flops as F

def make_step(cfg):
    def stepfn(p, m, v, x, y, i, lr):
        loss, g = jax.value_and_grad(M.loss_fn)(p, x, y, cfg)
        fp = PRM.flatten_params(p, cfg); fg = PRM.flatten_params(g, cfg)
        fp, m, v = opt.adamw_step(fp, fg, m, v, i, lr)
        return PRM.unflatten_params(fp, cfg), m, v, loss
    return jax.jit(stepfn, donate_argnums=(0,1,2))

def bench_step(cfg, B=64, n=10):
    params = PRM.init_params(cfg, jax.random.PRNGKey(0))
    N = PRM.num_parameters(cfg)
    m = jnp.zeros(N, jnp.float32); v = jnp.zeros(N, jnp.float32)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B,cfg.img_size,cfg.img_size,3), dtype=np.float32))
    y = jnp.asarray(rng.integers(0,cfg.num_classes,(B,)))
    f = make_step(cfg)
    params, m, v, loss = f(params, m, v, x, y, jnp.asarray(1,jnp.int32), jnp.asarray(1e-3,jnp.float32))
    _ = float(loss)
    t0=time.perf_counter()
    for i in range(2, n+2):
        params, m, v, loss = f(params, m, v, x, y, jnp.asarray(i,jnp.int32), jnp.asarray(1e-3,jnp.float32))
    _ = float(loss)
    return (time.perf_counter()-t0)/n

base = get_config("vit-b-16").replace(dtype="bfloat16")
kind = jax.devices()[0].device_kind
for name, cfg in [("fused", base.replace(use_flash=True)),
                  ("dense", base.replace(use_flash=False)),
                  ("fused+remat", base.replace(use_flash=True, remat=True))]:
    dt = bench_step(cfg)
    print(f"{name}: {dt*1e3:.1f} ms/step  MFU {F.mfu(64 / dt, cfg, kind):.1%}")
