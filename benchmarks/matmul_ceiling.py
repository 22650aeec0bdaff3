# run from the repo root
import time, jax, jax.numpy as jnp, numpy as np
rng = np.random.default_rng(0)
BT, C = 12608, 768
x = jnp.asarray(rng.standard_normal((BT, C)), jnp.bfloat16)
ws = [jnp.asarray(rng.standard_normal((C, 3*C)), jnp.bfloat16),
      jnp.asarray(rng.standard_normal((3*C, C)), jnp.bfloat16),
      jnp.asarray(rng.standard_normal((C, 4*C)), jnp.bfloat16),
      jnp.asarray(rng.standard_normal((4*C, C)), jnp.bfloat16)]

@jax.jit
def chain(x, ws):
    for _ in range(12):
        for w in ws:
            x = jnp.dot(x, w, preferred_element_type=jnp.bfloat16)
        x = x / jnp.float32(100.0).astype(jnp.bfloat16)  # keep from overflowing
    return x

r = chain(x, ws); _=float(jnp.sum(r.astype(jnp.float32)))
t0=time.perf_counter()
for _ in range(10): r = chain(x, ws)
_=float(jnp.sum(r.astype(jnp.float32)))
dt=(time.perf_counter()-t0)/10
flops = 2*BT*12*(C*3*C + 3*C*C + C*4*C + 4*C*C)
print(f"matmul chain: {dt*1e3:.2f} ms, {flops/dt/1e12:.1f} TF/s")
# bigger single matmul
M=8192; K=8192; N=8192
a = jnp.asarray(rng.standard_normal((M,K)), jnp.bfloat16); b = jnp.asarray(rng.standard_normal((K,N)), jnp.bfloat16)
f = jax.jit(lambda a,b: jnp.dot(a,b, preferred_element_type=jnp.bfloat16))
r=f(a,b); _=float(jnp.sum(r.astype(jnp.float32)))
t0=time.perf_counter()
for _ in range(10): r=f(a,b)
_=float(jnp.sum(r.astype(jnp.float32)))
dt=(time.perf_counter()-t0)/10
print(f"8k^3 matmul: {dt*1e3:.2f} ms, {2*M*K*N/dt/1e12:.1f} TF/s")
