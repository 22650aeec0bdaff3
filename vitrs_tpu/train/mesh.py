"""Mesh-spec launcher — ``vitrs-train --mesh dp=2,tp=2,pp=2``.

The reference never shipped an entry point at all (/root/reference/
train_vit.rs — no ``main``; SURVEY.md §1 L4), and through round 3 every
parallel family in this framework was reachable only through library
factories and tests: the shipped trainer hardcoded the DP mesh
(train/loop.py).  This module is the missing glue.  A mesh spec string
routes to the verified step factories, and every family is wrapped in ONE
uniform interface:

    plan = make_plan(cfg, parse_mesh("dp=2,tp=2,pp=2"), optimizer="adamw")
    params = plan.place(canonical_params)          # host -> sharded layout
    opt    = plan.init_opt(params)
    params, opt, loss = plan.step(params, opt, x, y, step, lr, wd)
    host   = plan.to_canonical(params)             # -> canonical checkpoint
    tree   = plan.opt_save(opt)                    # -> canonical side tree
    opt    = plan.opt_load(tree)                   # <- from ANY mesh's save

Checkpoints are always written in the CANONICAL single-device layout
(params.py's 16-tensor order; optimizer state keyed by canonical names), so
a run checkpointed under one mesh resumes under any other — dp=8 today,
dp=2,tp=2,pp=2 tomorrow — the same canonical<->TP conversion discipline the
Muon TP state converters established (parallel/muon_parallel.py:176-203).

Families (combinable per row, validated in make_plan):
  dp=N                      ZeRO-1 data parallelism (the train-loop default)
  dp,tp[,sp][,vp]           Megatron TP (+sequence parallel, +vocab-parallel
                            head/CE) — parallel/tensor_parallel.py
  dp,pp[,schedule,V]        GPipe / 1F1B / interleaved — parallel/pipeline.py
  dp,tp,pp[,sp]             3-D composed — parallel/threed.py
  dp,ep[,tp]                expert parallelism for MoE configs (AdamW or
                            sharded Adafactor) — parallel/expert_parallel.py
  dp,cp                     ring-attention context parallelism —
                            parallel/ring_attention.py
  fsdp=N[,dp=M]             ZeRO-3 GSPMD sharding; dp>1 = the hybrid pod
                            deployment (FSDP inside a host x DP
                            across domains) — parallel/fsdp.py
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import ViTConfig


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    cp: int = 1
    fsdp: int = 0          # ZeRO-3 over N devices (0 = off); exclusive
    sp: bool = False       # sequence parallelism inside TP
    vp: bool = False       # vocab-parallel head + CE (gpt TP)
    microbatches: int = 0  # pipeline microbatches (0 -> pp stage count)
    schedule: str = "gpipe"   # gpipe | 1f1b | 1f1b-interleaved
    virtual: int = 1       # virtual stages per device (interleaved)

    @property
    def n_devices(self) -> int:
        if self.fsdp:
            return self.fsdp * max(self.dp, 1)   # dp>1 = hybrid replica axis
        return self.dp * self.tp * self.pp * self.ep * self.cp

    def describe(self) -> str:
        parts = [f"{k}={getattr(self, k)}"
                 for k in ("dp", "tp", "pp", "ep", "cp")
                 if getattr(self, k) > 1]
        if self.fsdp:
            parts.append(f"fsdp={self.fsdp}")
        parts += [k for k in ("sp", "vp") if getattr(self, k)]
        if self.pp > 1:
            parts.append(self.schedule)
        return ",".join(parts) or "dp=1"


def parse_mesh(s: str) -> MeshSpec:
    """``"dp=2,tp=2,sp"`` -> MeshSpec.  Bare ``fsdp`` means all devices;
    bare ``sp``/``vp`` are flags; ``schedule=1f1b`` and ``v=2`` (virtual
    stages) configure the pipeline."""
    kw = {}
    for tok in filter(None, (t.strip() for t in s.split(","))):
        if "=" in tok:
            k, v = tok.split("=", 1)
            k = k.strip().lower()
            if k in ("schedule",):
                kw[k] = v.strip()
            elif k in ("sp", "vp"):
                kw[k] = v.strip().lower() in ("1", "true", "yes")
            elif k in ("v", "virtual"):
                kw["virtual"] = int(v)
            elif k in ("mb", "microbatches"):
                kw["microbatches"] = int(v)
            elif k in ("dp", "tp", "pp", "ep", "cp", "fsdp"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown mesh-spec key {k!r} in {s!r}")
        elif tok.lower() in ("sp", "vp"):
            kw[tok.lower()] = True
        elif tok.lower() == "fsdp":
            kw["fsdp"] = len(jax.devices())
        else:
            raise ValueError(f"unknown mesh-spec token {tok!r} in {s!r}")
    return MeshSpec(**kw)


@dataclasses.dataclass
class Plan:
    """Uniform handle over one parallel family's verified step factory."""
    kind: str
    mesh: object
    spec: MeshSpec
    optimizer: str
    batch_sharding: object
    # host canonical params -> device layout
    place: Callable
    # placed params -> opt state (tuple (m, v) or AdafactorState)
    init_opt: Callable
    # (params, opt, x, y, step, lr, wd) -> (params, opt, loss[, gnorm])
    step: Callable
    # placed params -> host canonical dict (numpy)
    to_canonical: Callable
    # opt state -> canonical host tree for checkpoint_tree.save_tree
    opt_save: Callable
    # canonical host tree -> placed opt state
    opt_load: Callable
    # step returns an extra pre-clip global grad-norm scalar
    returns_gnorm: bool = False
    # micro-batch accumulation factor baked into the step
    accum_steps: int = 1

    def validate_batch(self, batch: int, cfg: ViTConfig):
        s = self.spec
        data_ways = {"tp": s.dp, "pp": s.dp, "3d": s.dp,
                     "ep": s.dp * s.ep, "cp": s.dp,
                     "fsdp": s.fsdp * max(s.dp, 1)}[self.kind]
        assert batch % max(data_ways, 1) == 0, (
            f"batch {batch} must divide the data-sharding ways "
            f"({data_ways}) of mesh {s.describe()}")
        local = batch // max(data_ways, 1)
        assert local % self.accum_steps == 0, (
            f"per-data-shard batch {local} must divide accum_steps "
            f"{self.accum_steps}")
        if self.kind in ("pp", "3d"):
            mb = s.microbatches or s.pp
            assert (batch // s.dp // self.accum_steps) % mb == 0, (
                f"per-data-shard micro-slice "
                f"{batch // s.dp // self.accum_steps} must divide "
                f"microbatches {mb}")
        if self.kind == "cp":
            assert cfg.max_seq_len % s.cp == 0, (cfg.max_seq_len, s.cp)


def _af_saveload(AF, place_state):
    """(opt_save, opt_load) for an AdafactorState whose trees are keyed by
    the FAMILY's pytree names.  device_get yields GLOBAL arrays, so a save
    re-places under a different topology of the SAME family (tp=2 -> tp=4);
    across families the key sets differ and opt_load raises a KeyError —
    the mesh loop then re-inits (AdamW m/v stay the fully-portable
    canonical default)."""
    def opt_save(o):
        return {f: _get(getattr(o, f)) for f in ("vr", "vc", "vf")}

    def opt_load(tree):
        return place_state(AF.AdafactorState(
            *(jax.tree.map(jnp.asarray, tree[f])
              for f in ("vr", "vc", "vf")), {}))

    return opt_save, opt_load


def _adamw_tuple(factory_step, with_gnorm: bool = False):
    """Adapt (p, m, v, ...) -> (p, m, v, loss[, gnorm]) to the uniform
    (p, (m, v), ...) -> (p, (m, v), loss[, gnorm]) shape."""
    def step(p, opt, x, y, t, lr, wd):
        m, v = opt
        if with_gnorm:
            p, m, v, loss, gnorm = factory_step(p, m, v, x, y, t, lr, wd)
            return p, (m, v), loss, gnorm
        p, m, v, loss = factory_step(p, m, v, x, y, t, lr, wd)
        return p, (m, v), loss
    return step


@dataclasses.dataclass(frozen=True)
class TrainKnobs:
    """Production-training features baked into an AdamW mesh step
    (the DP path's semantics, parallel/gradops.py)."""
    accum_steps: int = 1
    clip_norm: float = 0.0
    log_grad_norm: bool = False

    @property
    def any(self) -> bool:
        return (self.accum_steps > 1 or self.clip_norm > 0.0
                or self.log_grad_norm)


def make_plan(cfg: ViTConfig, spec: MeshSpec, optimizer: str = "adamw",
              devices=None, knobs: TrainKnobs = TrainKnobs(),
              weight_decay: float = 0.0, muon_momentum: float = 0.95
              ) -> Optional[Plan]:
    """Build the Plan for a mesh spec; returns None for the pure-DP spec
    (the train loop's existing ZeRO-1 path owns that).  Raises on
    combinations no factory covers (the error names the missing piece).

    weight_decay/muon_momentum are factory-bound for Muon plans only (the
    Muon step signature carries the AdamW aux lr where the uniform step
    carries wd; every other optimizer takes wd per step)."""
    n_avail = len(devices) if devices is not None else len(jax.devices())
    assert spec.n_devices <= n_avail, (
        f"mesh {spec.describe()} needs {spec.n_devices} devices, "
        f"have {n_avail}")
    if knobs.any:
        assert optimizer == "adamw", (
            "clip_norm/accum_steps/log_grad_norm on the mesh path ride the "
            "AdamW steps (the DP path's contract); "
            f"--optimizer {optimizer} keeps the lean step")
    on = [k for k in ("tp", "pp", "ep", "cp") if getattr(spec, k) > 1]
    if spec.fsdp:
        assert not on, (
            "fsdp composes with dp only (the hybrid replica axis); "
            "tp/pp/ep/cp have their own plans")
        assert not knobs.any, (
            "fsdp keeps the lean GSPMD step (clip/accum: tp/pp/3d/ep)")
        return _fsdp_plan(cfg, spec, optimizer, devices,
                          weight_decay=weight_decay,
                          muon_momentum=muon_momentum)
    if not on:
        return None                      # pure DP: train loop's native path
    if "cp" in on:
        assert on == ["cp"], f"cp composes with dp only (got {on})"
        assert optimizer in ("adamw", "adafactor"), (
            "cp ships AdamW (ZeRO-1) and Adafactor (replicated-state) steps")
        assert not knobs.any, (
            "cp keeps the lean ring step (clip/accum: tp/pp/3d/ep)")
        return _cp_plan(cfg, spec, devices, optimizer)
    if "ep" in on:
        assert all(k in ("ep", "tp") for k in on), (
            f"ep composes with dp and tp (got {on})")
        if knobs.any:
            assert spec.tp == 1, (
                "clip/accum are wired for dp x ep (the ep x tp step is lean)")
        return _ep_plan(cfg, spec, optimizer, devices, knobs)
    assert optimizer in ("adamw", "adafactor", "muon"), (
        f"mesh {spec.describe()} ships AdamW/Adafactor/Muon steps; "
        f"--optimizer {optimizer} is the dp path's")
    if "tp" in on and "pp" in on:
        assert optimizer != "muon", (
            "muon rides tp and fsdp meshes (3-D: adamw/adafactor)")
        return _3d_plan(cfg, spec, devices, optimizer, knobs)
    if "pp" in on:
        assert optimizer != "muon", (
            "muon rides tp and fsdp meshes (pp: adamw/adafactor)")
        return _pp_plan(cfg, spec, devices, optimizer, knobs)
    return _tp_plan(cfg, spec, devices, optimizer, knobs,
                    weight_decay=weight_decay, muon_momentum=muon_momentum)


# --- family plans ------------------------------------------------------------

def _get(tree):
    return {k: np.asarray(jax.device_get(v)) for k, v in tree.items()}


def _tp_plan(cfg, spec, devices, optimizer="adamw", knobs=TrainKnobs(),
             weight_decay=0.0, muon_momentum=0.95):
    from ..parallel import tensor_parallel as TP
    mesh = TP.make_mesh_2d(spec.dp, spec.tp, devices)
    pspecs = TP.tp_param_specs(cfg, spec.vp)
    if optimizer == "muon":
        from ..ops import muon as MU
        from ..parallel import muon_parallel as MP
        assert not spec.vp, (
            "muon under TP has no vocab-parallel head variant "
            "(parallel/muon_parallel.py) — drop vp or use adamw")
        raw = MP.make_tp_muon_train_step(
            cfg, mesh, sequence_parallel=spec.sp,
            momentum=muon_momentum, weight_decay=weight_decay)

        def step(p, opt_, x, y, t, lr, alr):
            # the uniform 7th slot carries the Muon aux (AdamW) lr — the
            # mesh loop computes it from muon_adamw_lr, the wd is bound
            # at factory time (the DP muon contract, train/loop.py)
            mom, m, v = opt_
            p, mom, m, v, loss = raw(p, mom, m, v, x, y, t, lr, alr)
            return p, (mom, m, v), loss

        def opt_save(o):
            mom, m, v = (_get(t) for t in o)
            st = MP.muon_state_from_tp(
                {k: jnp.asarray(x) for k, x in mom.items()},
                {k: jnp.asarray(x) for k, x in m.items()},
                {k: jnp.asarray(x) for k, x in v.items()}, cfg)
            return {"momentum": {k: np.asarray(x)
                                 for k, x in st.momentum.items()},
                    "m": {k: np.asarray(x) for k, x in st.m.items()},
                    "v": {k: np.asarray(x) for k, x in st.v.items()}}

        def opt_load(tree):
            st = MU.MuonState(
                momentum=jax.tree.map(jnp.asarray, tree["momentum"]),
                m=jax.tree.map(jnp.asarray, tree["m"]),
                v=jax.tree.map(jnp.asarray, tree["v"]))
            return MP.place_tp_muon_state(st, cfg, mesh)

        return Plan(
            kind="tp", mesh=mesh, spec=spec, optimizer="muon",
            batch_sharding=NamedSharding(mesh, P("data")),
            place=lambda p: TP.place_tp_params(p, cfg, mesh, spec.vp),
            init_opt=lambda p: MP.init_tp_muon_state(p, cfg, mesh),
            step=step,
            to_canonical=lambda p: _get(TP.from_tp_params(p, cfg, spec.vp)),
            opt_save=opt_save, opt_load=opt_load)
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        raw = TP.make_tp_train_step_adafactor(
            cfg, mesh, sequence_parallel=spec.sp, vocab_parallel=spec.vp)

        def place_state(st):
            sp = AF.state_specs(TP.tp_global_shapes(cfg, spec.vp), pspecs)
            return AF.AdafactorState(
                *({k: jax.device_put(v, NamedSharding(mesh, getattr(sp, f)[k]))
                   for k, v in getattr(st, f).items()}
                  for f in ("vr", "vc", "vf")), {})

        opt_save, opt_load = _af_saveload(AF, place_state)
        return Plan(
            kind="tp", mesh=mesh, spec=spec, optimizer="adafactor",
            batch_sharding=NamedSharding(mesh, P("data")),
            place=lambda p: TP.place_tp_params(p, cfg, mesh, spec.vp),
            init_opt=lambda p: TP.init_tp_af_state(p, mesh, cfg, spec.vp),
            step=raw,
            to_canonical=lambda p: _get(TP.from_tp_params(p, cfg, spec.vp)),
            opt_save=opt_save, opt_load=opt_load)
    step = _adamw_tuple(TP.make_tp_train_step(
        cfg, mesh, sequence_parallel=spec.sp, vocab_parallel=spec.vp,
        accum_steps=knobs.accum_steps, clip_norm=knobs.clip_norm,
        return_grad_norm=knobs.log_grad_norm), knobs.log_grad_norm)

    def opt_load(tree):
        return tuple(
            {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, pspecs[k]))
             for k, v in TP.to_tp_params(
                 jax.tree.map(jnp.asarray, tree[key]), cfg, spec.vp).items()}
            for key in ("m", "v"))

    return Plan(
        kind="tp", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=NamedSharding(mesh, P("data")),
        place=lambda p: TP.place_tp_params(p, cfg, mesh, spec.vp),
        init_opt=lambda p: TP.init_tp_opt_state(p, mesh, cfg, spec.vp),
        step=step, returns_gnorm=knobs.log_grad_norm,
        accum_steps=knobs.accum_steps,
        to_canonical=lambda p: _get(TP.from_tp_params(p, cfg, spec.vp)),
        opt_save=lambda o: {"m": _get(TP.from_tp_params(o[0], cfg, spec.vp)),
                            "v": _get(TP.from_tp_params(o[1], cfg, spec.vp))},
        opt_load=opt_load)


def _pp_plan(cfg, spec, devices, optimizer="adamw", knobs=TrainKnobs()):
    from ..parallel import pipeline as PP
    mesh = PP.make_mesh_dp_pp(spec.dp, spec.pp, devices)
    mb = spec.microbatches or spec.pp
    inter = spec.schedule == "1f1b-interleaved"
    V = spec.virtual if inter else 1
    pspecs = PP.pp_param_specs(cfg)
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        raw = PP.make_pp_train_step_adafactor(
            cfg, mesh, microbatches=mb, schedule=spec.schedule,
            virtual_stages=V)

        def place_state(st):
            fac, gshapes = PP.pp_af_factored(cfg)
            sp = PP._af_specs_with_fac(gshapes, pspecs, fac)
            if inter:
                # state leaves permute their leading L axis like the params
                st = AF.AdafactorState(
                    *(PP.permute_af_tree(getattr(st, f), cfg, spec.pp, V)
                      for f in ("vr", "vc", "vf")), {})
            return AF.AdafactorState(
                *({k: jax.device_put(jnp.asarray(v),
                                     NamedSharding(mesh, getattr(sp, f)[k]))
                   for k, v in getattr(st, f).items()}
                  for f in ("vr", "vc", "vf")), {})

        opt_save, opt_load = _af_saveload(AF, place_state)
        if inter:
            def opt_save(o):        # noqa: F811 — canonical-order save
                return {f: PP.permute_af_tree(_get(getattr(o, f)), cfg,
                                              spec.pp, V, inverse=True)
                        for f in ("vr", "vc", "vf")}

        def pl(p):
            if inter:
                return PP.place_pp_params_interleaved(p, cfg, mesh, V)
            return PP.place_pp_params(p, cfg, mesh)

        def to_canon(p):
            host = _get(p)
            if inter:
                host = PP.uninterleave_tree(host, cfg, spec.pp, V)
            return host

        return Plan(
            kind="pp", mesh=mesh, spec=spec, optimizer="adafactor",
            batch_sharding=NamedSharding(mesh, P("data")),
            place=pl,
            init_opt=lambda p: PP.init_pp_af_state(p, mesh, cfg),
            step=raw, to_canonical=to_canon,
            opt_save=opt_save, opt_load=opt_load)
    step = _adamw_tuple(PP.make_pp_train_step(
        cfg, mesh, microbatches=mb, schedule=spec.schedule,
        virtual_stages=V, accum_steps=knobs.accum_steps,
        clip_norm=knobs.clip_norm,
        return_grad_norm=knobs.log_grad_norm), knobs.log_grad_norm)

    def place(p):
        if inter:
            return PP.place_pp_params_interleaved(p, cfg, mesh, V)
        return PP.place_pp_params(p, cfg, mesh)

    def to_canonical(p):
        host = _get(p)
        if inter:
            host = PP.uninterleave_tree(host, cfg, spec.pp, V)
        return host

    def opt_load(tree):
        return tuple(place(jax.tree.map(jnp.asarray, tree[key]))
                     for key in ("m", "v"))

    return Plan(
        kind="pp", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=NamedSharding(mesh, P("data")),
        place=place,
        init_opt=lambda p: PP.init_pp_opt_state(p, mesh, cfg),
        step=step, returns_gnorm=knobs.log_grad_norm,
        accum_steps=knobs.accum_steps,
        to_canonical=to_canonical,
        opt_save=lambda o: {"m": to_canonical(o[0]), "v": to_canonical(o[1])},
        opt_load=opt_load)


def _3d_plan(cfg, spec, devices, optimizer="adamw", knobs=TrainKnobs()):
    from ..parallel import threed as TD
    from ..parallel import tensor_parallel as TP
    mesh = TD.make_mesh_3d(spec.dp, spec.tp, spec.pp, devices)
    mb = spec.microbatches or spec.pp
    vp = spec.vp
    pspecs = TD.param_specs_3d(cfg, vp)
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        from ..parallel.pipeline import _af_specs_with_fac
        raw = TD.make_3d_train_step_adafactor(
            cfg, mesh, microbatches=mb, sequence_parallel=spec.sp,
            vocab_parallel=vp)

        def place_state(st):
            fac, gshapes = TD.threed_af_factored(cfg, vp)
            sp = _af_specs_with_fac(gshapes, pspecs, fac)
            return AF.AdafactorState(
                *({k: jax.device_put(v, NamedSharding(mesh, getattr(sp, f)[k]))
                   for k, v in getattr(st, f).items()}
                  for f in ("vr", "vc", "vf")), {})

        opt_save, opt_load = _af_saveload(AF, place_state)
        return Plan(
            kind="3d", mesh=mesh, spec=spec, optimizer="adafactor",
            batch_sharding=NamedSharding(mesh, P("data")),
            place=lambda p: TD.place_params_3d(p, cfg, mesh, vp),
            init_opt=lambda p: TD.init_af_state_3d(p, mesh, cfg, vp),
            step=raw,
            to_canonical=lambda p: _get(TP.from_tp_params(p, cfg, vp)),
            opt_save=opt_save, opt_load=opt_load)
    step = _adamw_tuple(TD.make_3d_train_step(
        cfg, mesh, microbatches=mb, sequence_parallel=spec.sp,
        vocab_parallel=vp, accum_steps=knobs.accum_steps,
        clip_norm=knobs.clip_norm,
        return_grad_norm=knobs.log_grad_norm), knobs.log_grad_norm)

    def opt_load(tree):
        return tuple(
            {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, pspecs[k]))
             for k, v in TP.to_tp_params(
                 jax.tree.map(jnp.asarray, tree[key]), cfg, vp).items()}
            for key in ("m", "v"))

    return Plan(
        kind="3d", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=NamedSharding(mesh, P("data")),
        place=lambda p: TD.place_params_3d(p, cfg, mesh, vp),
        init_opt=lambda p: TD.init_opt_state_3d(p, mesh, cfg, vp),
        step=step, returns_gnorm=knobs.log_grad_norm,
        accum_steps=knobs.accum_steps,
        to_canonical=lambda p: _get(TP.from_tp_params(p, cfg, vp)),
        opt_save=lambda o: {"m": _get(TP.from_tp_params(o[0], cfg, vp)),
                            "v": _get(TP.from_tp_params(o[1], cfg, vp))},
        opt_load=opt_load)


def _ep_plan(cfg, spec, optimizer, devices, knobs=TrainKnobs()):
    from ..parallel import expert_parallel as EP
    assert cfg.is_moe, "--mesh ep=N needs a MoE config (--num-experts)"
    if spec.tp > 1:
        return _ep_tp_plan(cfg, spec, optimizer, devices)
    mesh = EP.make_mesh_dp_ep(spec.dp, spec.ep, devices)
    batch_sh = NamedSharding(mesh, P(("data", "expert")))
    pspecs = EP.ep_param_specs(cfg)

    def place(p):
        return EP.place_ep_params(p, cfg, mesh)

    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        raw = EP.make_ep_train_step_adafactor(cfg, mesh)

        def step(p, opt, x, y, t, lr, wd):
            p, opt, loss = raw(p, opt, x, y, t, lr, wd)
            return p, opt, loss

        def opt_save(o):
            return {k: _get(getattr(o, k)) for k in ("vr", "vc", "vf")}

        def opt_load(tree):
            from ..params import param_shapes
            sp = EP.af_state_specs(
                {k: jax.ShapeDtypeStruct(s, jnp.float32)
                 for k, s in param_shapes(cfg).items()}, cfg)
            return AF.AdafactorState(
                *({k: jax.device_put(jnp.asarray(v),
                                     NamedSharding(mesh, getattr(sp, f)[k]))
                   for k, v in tree[f].items()}
                  for f in ("vr", "vc", "vf")), {})

        return Plan(kind="ep", mesh=mesh, spec=spec, optimizer="adafactor",
                    batch_sharding=batch_sh, place=place,
                    init_opt=lambda p: EP.init_ep_af_state(p, cfg, mesh),
                    step=step, to_canonical=_get,
                    opt_save=opt_save, opt_load=opt_load)

    assert optimizer == "adamw", optimizer
    step = _adamw_tuple(EP.make_ep_train_step(
        cfg, mesh, accum_steps=knobs.accum_steps, clip_norm=knobs.clip_norm,
        return_grad_norm=knobs.log_grad_norm), knobs.log_grad_norm)

    def opt_load(tree):
        return tuple(
            {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, pspecs[k]))
             for k, v in tree[key].items()}
            for key in ("m", "v"))

    return Plan(
        kind="ep", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=batch_sh, place=place,
        init_opt=lambda p: EP.init_ep_opt_state(p, cfg, mesh),
        step=step, returns_gnorm=knobs.log_grad_norm,
        accum_steps=knobs.accum_steps, to_canonical=_get,
        opt_save=lambda o: {"m": _get(o[0]), "v": _get(o[1])},
        opt_load=opt_load)


def _ep_tp_plan(cfg, spec, optimizer, devices):
    from ..parallel import expert_parallel as EP
    assert optimizer in ("adamw", "adafactor"), (
        "ep x tp ships AdamW and Adafactor steps")
    mesh = EP.make_mesh_dp_ep_tp(spec.dp, spec.ep, spec.tp, devices)
    batch_sh = NamedSharding(mesh, P(("data", "expert")))
    vp = spec.vp
    pspecs = EP.ep_tp_param_specs(cfg, vp)
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        raw = EP.make_ep_tp_train_step_adafactor(cfg, mesh,
                                                 vocab_parallel=vp)

        def place_state(st):
            sp = EP.ep_tp_af_state_specs(cfg, vp)
            return AF.AdafactorState(
                *({k: jax.device_put(jnp.asarray(v),
                                     NamedSharding(mesh, getattr(sp, f)[k]))
                   for k, v in getattr(st, f).items()}
                  for f in ("vr", "vc", "vf")), {})

        opt_save, opt_load = _af_saveload(AF, place_state)
        return Plan(
            kind="ep", mesh=mesh, spec=spec, optimizer="adafactor",
            batch_sharding=batch_sh,
            place=lambda p: EP.place_ep_tp_params(p, cfg, mesh, vp),
            init_opt=lambda p: EP.init_ep_tp_af_state(p, cfg, mesh, vp),
            step=raw,
            to_canonical=lambda p: _get(EP.from_ep_tp_params(p, cfg, vp)),
            opt_save=opt_save, opt_load=opt_load)
    step = _adamw_tuple(EP.make_ep_tp_train_step(cfg, mesh,
                                                 vocab_parallel=vp))

    def opt_load(tree):
        return tuple(
            {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, pspecs[k]))
             for k, v in EP.to_ep_tp_params(
                 jax.tree.map(jnp.asarray, tree[key]), cfg, vp).items()}
            for key in ("m", "v"))

    return Plan(
        kind="ep", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=batch_sh,
        place=lambda p: EP.place_ep_tp_params(p, cfg, mesh, vp),
        init_opt=lambda p: EP.init_ep_tp_opt_state(p, cfg, mesh, vp),
        step=step,
        to_canonical=lambda p: _get(EP.from_ep_tp_params(p, cfg, vp)),
        opt_save=lambda o: {"m": _get(EP.from_ep_tp_params(o[0], cfg, vp)),
                            "v": _get(EP.from_ep_tp_params(o[1], cfg, vp))},
        opt_load=opt_load)


def _cp_plan(cfg, spec, devices, optimizer="adamw"):
    from ..parallel import ring_attention as RA
    from .. import params as PRM
    assert cfg.mode == "gpt", "cp (ring attention) serves gpt configs"
    mesh = RA.make_mesh_dp_cp(spec.dp, spec.cp, devices)
    if optimizer == "adafactor":
        from ..ops import adafactor as AF
        raw_af = RA.make_cp_train_step_adafactor(cfg, mesh)
        repl = NamedSharding(mesh, P())

        def place_af(p):
            return {k: jax.device_put(jnp.asarray(v), repl)
                    for k, v in p.items()}

        def place_state(st):
            return AF.AdafactorState(
                *({k: jax.device_put(jnp.asarray(v), repl)
                   for k, v in getattr(st, f).items()}
                  for f in ("vr", "vc", "vf")), {})

        opt_save, opt_load = _af_saveload(AF, place_state)
        return Plan(
            kind="cp", mesh=mesh, spec=spec, optimizer="adafactor",
            batch_sharding=NamedSharding(mesh, P("data", "ctx")),
            place=place_af,
            init_opt=lambda p: RA.init_cp_af_state(p, mesh),
            step=raw_af, to_canonical=_get,
            opt_save=opt_save, opt_load=opt_load)
    raw = RA.make_cp_train_step(cfg, mesh)
    n = PRM.num_parameters(cfg)
    size = mesh.size
    n_pad = ((n + size - 1) // size) * size
    opt_sh = NamedSharding(mesh, P(("data", "ctx")))
    shapes = PRM.param_shapes(cfg)
    order = PRM.tensor_order(cfg)

    def place(p):
        return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P()))
                for k, v in p.items()}

    def _flat_to_named(vec):
        # canonical name-keyed dict (the module contract every other
        # family's opt_save honors), carved from cp's flat AdamW vector
        out, off = {}, 0
        for name in order:
            sz = int(np.prod(shapes[name]))
            out[name] = np.asarray(vec[off:off + sz],
                                   np.float32).reshape(shapes[name])
            off += sz
        assert off == n, (off, n)
        return out

    def _named_to_flat(tree):
        if not isinstance(tree, dict):          # legacy flat-vector save
            return np.asarray(tree, np.float32)
        return np.concatenate([np.asarray(tree[name], np.float32).reshape(-1)
                               for name in order])

    def opt_load(tree):
        return tuple(
            jax.device_put(np.pad(_named_to_flat(tree[key]), (0, n_pad - n)),
                           opt_sh)
            for key in ("m", "v"))

    return Plan(
        kind="cp", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=NamedSharding(mesh, P("data", "ctx")),
        place=place,
        init_opt=lambda p: RA.init_cp_opt_state(cfg, mesh),
        step=_adamw_tuple(raw), to_canonical=_get,
        opt_save=lambda o: {
            "m": _flat_to_named(np.asarray(jax.device_get(o[0]))[:n]),
            "v": _flat_to_named(np.asarray(jax.device_get(o[1]))[:n])},
        opt_load=opt_load)


def _fsdp_plan(cfg, spec, optimizer, devices, weight_decay=0.0,
               muon_momentum=0.95):
    from ..parallel import fsdp as FS
    from .. import params as PRM
    if spec.dp > 1:
        # hybrid: FSDP inside a host x DP across hosts
        mesh = FS.make_hybrid_mesh(spec.dp, spec.fsdp, devices)
    else:
        mesh = FS.make_mesh(spec.fsdp, devices)
    batch_sh = NamedSharding(mesh, FS.batch_spec(mesh))
    shapes = {k: jax.ShapeDtypeStruct(s, jnp.dtype(cfg.dtype))
              for k, s in PRM.param_shapes(cfg).items()}
    pspecs = FS.param_specs(shapes, mesh)
    if optimizer == "muon":
        from ..ops import muon as MU
        from ..parallel import muon_parallel as MP
        raw = MP.make_fsdp_muon_train_step(
            cfg, mesh, shapes, momentum=muon_momentum,
            weight_decay=weight_decay)

        def step(p, st, x, y, t, lr, alr):
            # 7th slot carries the Muon aux (AdamW) lr; wd factory-bound
            p, st, loss = raw(p, st, x, y, t, lr, alr)
            return p, st, loss

        def opt_save(o):
            return {"momentum": _get(o.momentum), "m": _get(o.m),
                    "v": _get(o.v)}

        def opt_load(tree):
            st = MU.MuonState(
                momentum=jax.tree.map(jnp.asarray, tree["momentum"]),
                m=jax.tree.map(jnp.asarray, tree["m"]),
                v=jax.tree.map(jnp.asarray, tree["v"]))
            psh = {k: NamedSharding(mesh, s) for k, s in pspecs.items()}
            return MU.MuonState(
                momentum={k: jax.device_put(v, psh[k])
                          for k, v in st.momentum.items()},
                m={k: jax.device_put(v, psh[k]) for k, v in st.m.items()},
                v={k: jax.device_put(v, psh[k]) for k, v in st.v.items()})

        return Plan(kind="fsdp", mesh=mesh, spec=spec, optimizer="muon",
                    batch_sharding=batch_sh,
                    place=lambda p: FS.place_params(p, mesh),
                    init_opt=lambda p: MP.init_fsdp_muon_state(p, mesh),
                    step=step, to_canonical=_get,
                    opt_save=opt_save, opt_load=opt_load)
    if optimizer == "adafactor":
        raw = FS.make_fsdp_train_step_adafactor(cfg, mesh, shapes)
        from ..ops import adafactor as AF

        def opt_save(o):
            return {k: _get(getattr(o, k)) for k in ("vr", "vc", "vf")}

        def opt_load(tree):
            st = AF.AdafactorState(
                *(jax.tree.map(jnp.asarray, tree[f])
                  for f in ("vr", "vc", "vf")), {})
            return FS.place_af_state(st, shapes, mesh)

        return Plan(kind="fsdp", mesh=mesh, spec=spec, optimizer="adafactor",
                    batch_sharding=batch_sh,
                    place=lambda p: FS.place_params(p, mesh),
                    init_opt=lambda p: FS.init_af_state(p, mesh),
                    step=raw, to_canonical=_get,
                    opt_save=opt_save, opt_load=opt_load)
    assert optimizer == "adamw", optimizer
    wrapped = {}

    def step(p, opt, x, y, t, lr, wd):
        # weight decay is bound at factory time in the FSDP step; rebuild
        # lazily on first call (wd is a host scalar from TrainConfig)
        key = float(wd)
        if key not in wrapped:
            wrapped[key] = FS.make_fsdp_train_step(cfg, mesh, p,
                                                   weight_decay=key)
        m, v = opt
        p, m, v, loss = wrapped[key](p, m, v, x, y, t, lr)
        return p, (m, v), loss

    def opt_load(tree):
        return tuple(
            {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, pspecs[k]))
             for k, v in tree[key].items()}
            for key in ("m", "v"))

    return Plan(
        kind="fsdp", mesh=mesh, spec=spec, optimizer="adamw",
        batch_sharding=batch_sh,
        place=lambda p: FS.place_params(p, mesh),
        init_opt=lambda p: FS.init_opt_state(p, mesh),
        step=step, to_canonical=_get,
        opt_save=lambda o: {"m": _get(o[0]), "v": _get(o[1])},
        opt_load=opt_load)
