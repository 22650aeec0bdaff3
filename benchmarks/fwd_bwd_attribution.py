# run from the repo root
import time, jax, jax.numpy as jnp, numpy as np
from vitrs_tpu import params as PRM
from vitrs_tpu.config import get_config
from vitrs_tpu.models import model as M

def timeit(f, *a, n=10, sync=lambda r: float(r)):
    r = f(*a); sync(r)
    t0=time.perf_counter()
    for _ in range(n): r = f(*a)
    sync(r)
    return (time.perf_counter()-t0)/n

cfg = get_config("vit-b-16").replace(dtype="bfloat16", use_flash=True)
params = PRM.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
B=64
x = jnp.asarray(rng.standard_normal((B,224,224,3), dtype=np.float32))
y = jnp.asarray(rng.integers(0,1000,(B,)))

fwd = jax.jit(lambda p,x,y: M.loss_fn(p,x,y,cfg))
t_f = timeit(fwd, params, x, y)

def g_loss(p,x,y):
    loss, g = jax.value_and_grad(M.loss_fn)(p,x,y,cfg)
    return loss, g
gradf = jax.jit(g_loss)
def sync_g(r):
    loss, g = r
    return float(loss) + float(jnp.sum(g["lnfb"]))  # forces backward outputs
t_g = timeit(gradf, params, x, y, sync=sync_g)
print(f"fwd {t_f*1e3:.1f} ms | fwd+bwd {t_g*1e3:.1f} ms | bwd/fwd ratio {(t_g-t_f)/t_f:.2f}")
# attention-only cost: model with 0-flops attention? approximate with identity attention
orig = M.attention
M.attention = lambda qkv, nh, **kw: qkv[..., :qkv.shape[-1]//3]
fwd2 = jax.jit(lambda p,x,y: M.loss_fn(p,x,y,cfg))
t_f2 = timeit(fwd2, params, x, y)
gradf2 = jax.jit(g_loss)
t_g2 = timeit(gradf2, params, x, y, sync=sync_g)
M.attention = orig
print(f"no-attn: fwd {t_f2*1e3:.1f} ms, fwd+bwd {t_g2*1e3:.1f} ms -> attention costs fwd {1e3*(t_f-t_f2):.1f} ms, train {1e3*(t_g-t_g2):.1f} ms")
