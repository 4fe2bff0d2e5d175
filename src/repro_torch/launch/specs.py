"""Step functions and the (arch x shape x mesh) cells built on them.

The step trains every family: `lm_loss` for the decoder LMs (dense,
MoE, the Mamba2 hybrid, xLSTM), `encdec_loss` for the encoder-decoder,
whose batches carry `src_emb` beside `tokens`.

A cell is everything one (arch x shape x mesh) program needs: the step
function and its arguments placed by the sharding rules
(`sharding/rules.py`) as DTensors on the mesh's `DeviceMesh`.  The
reference builds `ShapeDtypeStruct` trees and `NamedSharding`s for
XLA's dry run (`jax.jit(fn, in_shardings=...)`); here the arguments are
meta DTensors for the dry run (`launch/dryrun.py`, on a fake process
group) or real ones for a run, and `fn` takes them as they are.  The
default process group must hold one rank per mesh entry.  Inside `fn`
a plain tensor meets a DTensor as a replicated one
(`implicit_replication`).  The model lays its sharded work out itself
(`sharding/hints.py`); a view that the shards cannot follow is, as a
last resort, taken of the view's dims replicated and recorded in
`fn.fallbacks` (`sharding/hints.py::ViewResharding`).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.core.guard import GuardConfig, guard_init, guard_step
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import (EncDec, decode_train,
                                       encdec_decode_step, encdec_loss,
                                       encode, init_encdec_cache,
                                       init_encdec_params)
from repro_torch.models.layers import unembed
from repro_torch.models.transformer import (LM, init_cache, init_lm_params,
                                            lm_backbone, lm_decode_step,
                                            lm_logits, lm_loss)
from repro_torch.optim import adamw
from repro_torch.sharding.hints import ViewResharding
from repro_torch.sharding.rules import (batch_spec, params_shardings,
                                        placements, state_cache_shardings)
from repro_torch.tree import tree_map

__all__ = ["GUARD_CFG", "CellSpec", "make_train_step", "pick_accum_steps",
           "build_train_cell", "build_prefill_cell", "build_decode_cell",
           "build_cell", "Placer", "distribute_model", "on_dtensors"]

GUARD_CFG = GuardConfig(m=3.0, warmup_steps=50, channels=2)


class CellSpec(NamedTuple):
    """Everything needed to run or trace one (arch x shape x mesh)
    cell: `fn(*args)`; the specs the arguments were placed by and those
    of the outputs (`None` where the reference leaves them to GSPMD);
    the arguments the step writes in place (the reference's donated
    ones); the tokens D of 6ND bookkeeping."""
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    token_count: int


# ------------------------------------------------------------ builders --
def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    accum_steps: int = 1, unroll_accum: bool = False,
                    guard_cfg: GuardConfig = GUARD_CFG,
                    micro_shardings=None):
    """Train step with optional gradient accumulation (microbatching).

    `train_step(model, opt_state, guard_state, batch)` returns
    `(model, opt_state, guard_state, metrics)`: the model's parameters
    and the optimizer's moments are updated in place, and every metric
    is a 0-dim device tensor (nothing is read back to the host).  With
    `accum_steps` = k the batch is split into k microbatches whose
    gradients are summed in `opt_cfg.grad_dtype` and divided by k
    (every batch entry, `src_emb` included, is split along its first
    axis).  The microbatch loop is a Python loop, so `unroll_accum` (the
    reference's switch from `lax.scan` to an unrolled loop for XLA's
    flop count) changes nothing.  `micro_shardings` ({batch entry:
    spec of one microbatch}) places each microbatch of a DTensor batch
    by its spec, where a split of a batch-sharded DTensor would
    otherwise leave it replicated.
    """
    del unroll_accum  # the loop below is always unrolled
    loss_fn = encdec_loss if cfg.family == "encdec" else lm_loss

    def place(micro):
        if micro_shardings is None:
            return micro
        return {n: v.redistribute(v.device_mesh, placements(
            v.device_mesh, micro_shardings[n])) for n, v in micro.items()}

    def train_step(model, opt_state, guard_state, batch):
        params = dict(model.named_parameters())
        if accum_steps == 1:
            model.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(model, batch, cfg)
            loss.backward()
            grads = {n: p.grad for n, p in params.items()}
        else:
            k = accum_steps
            acc_dt = getattr(torch, opt_cfg.grad_dtype)
            grads = {n: torch.zeros_like(p, dtype=acc_dt,
                                         requires_grad=False)
                     for n, p in params.items()}
            lsum, per_micro = 0.0, []
            for micro in _split(batch, k):
                loss_i, m_i = loss_fn(model, place(micro), cfg)
                gi = torch.autograd.grad(loss_i, list(params.values()))
                for a, g in zip(grads.values(), gi):
                    a.add_(g.to(acc_dt))
                lsum = lsum + loss_i.detach()
                per_micro.append({n: v.detach() for n, v in m_i.items()})
            grads = {n: g / k for n, g in grads.items()}
            loss = lsum / k
            metrics = {n: torch.stack([m[n] for m in per_micro]).mean()
                       for n in per_micro[0]}
        loss = loss.detach()
        metrics = {n: v.detach() for n, v in metrics.items()}
        gnorm = adamw.global_norm(grads)
        # TEDA guard on (loss, grad-norm) telemetry — the paper's
        # detector deciding whether this step may touch the weights
        guard_state, verdict = guard_step(
            guard_state, torch.stack([loss.float(), gnorm]), guard_cfg)
        _, opt_state, om = adamw.update(
            grads, opt_state, params, opt_cfg, skip=verdict.skip)
        del grads
        model.zero_grad(set_to_none=True)
        metrics = dict(metrics, loss=loss, **om)
        return model, opt_state, guard_state, metrics

    return train_step


def _split(batch, k: int):
    """k microbatches along the batch axis."""
    for n, v in batch.items():
        if v.shape[0] % k:
            raise ValueError(f"batch {n!r} of {v.shape[0]} rows does not "
                             f"split into {k} microbatches")
    parts = {n: torch.chunk(v, k, dim=0) for n, v in batch.items()}
    return [{n: parts[n][i] for n in batch} for i in range(k)]


def pick_accum_steps(mesh, global_batch: int, seq_len: int,
                     d_model: int = 2048,
                     token_dim_budget: int = 8192 * 2048) -> int:
    """Smallest divisor k of the per-dp-shard batch such that each
    microbatch holds <= budget token-dims (tokens x d_model) per
    data-parallel shard — activation memory scales with that product."""
    target_tokens_per_row = max(1024, token_dim_budget // max(d_model, 1))
    sizes = dict(mesh.shape)
    dp_total = 1
    for a in ("pod", "data"):
        dp_total *= sizes.get(a, 1)
    if global_batch % dp_total:
        dp_total = sizes.get("data", 1)
    per_row = max(global_batch // max(dp_total, 1), 1)
    tokens_row = per_row * seq_len
    k0 = max(1, -(-tokens_row // target_tokens_per_row))
    for k in range(k0, per_row + 1):
        if per_row % k == 0:
            return k
    return per_row


# --------------------------------------------------------------- cells --
def on_dtensors(fn):
    """`fn` with plain tensors read as replicated DTensors and views
    resharded where DTensor's shards cannot follow them; each such
    retry of its calls is appended to its `fallbacks` list."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(fn)
    def run(*args):
        with implicit_replication(), ViewResharding(run.fallbacks):
            return fn(*args)

    run.fallbacks = []
    return run


class Placer:
    """Places tensors on `dmesh` by spec.  A real tensor is split from
    its own copy on each rank (every rank builds the same tensors from
    the same seed: no scatter from rank 0); a meta tensor stays on meta,
    or with `shard_device` becomes this rank's shard alone, zero-filled
    on that device (a share of a mesh the process only describes)."""

    def __init__(self, mesh, dmesh, shard_device=None):
        self.mesh, self.dmesh = mesh, dmesh
        self.shard_device = shard_device

    def __call__(self, t, spec):
        from torch.distributed.tensor import DTensor, distribute_tensor
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        pl = placements(self.mesh, spec)
        if self.shard_device is None or t.device.type != "meta":
            return distribute_tensor(t, self.dmesh, pl, src_data_rank=None)
        shape, _ = compute_local_shape_and_global_offset(
            t.shape, self.dmesh, pl)
        local = torch.zeros(shape, dtype=t.dtype, device=self.shard_device)
        return DTensor.from_local(local, self.dmesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())


def distribute_model(model, place, specs=None, local: bool = False):
    """Replace each parameter of `model` (in place) by a DTensor
    parameter, `place(tensor, spec)` with its spec in `specs` (as
    `params_shardings` gives them); with `local`, each DTensor
    parameter by its local tensor instead.  Returns `model`."""
    for name, p in list(model.named_parameters()):
        owner, leaf = name.rpartition(".")[::2]
        mod = model.get_submodule(owner) if owner else model
        t = (p.detach().to_local() if local
             else place(p.detach(), specs[name]))
        setattr(mod, leaf, torch.nn.Parameter(
            t, requires_grad=p.requires_grad))
    return model


def _param_template(cfg: ModelConfig):
    """The model with unfilled parameters on the meta device (shapes and
    dtypes only)."""
    cls = EncDec if cfg.family == "encdec" else LM
    return cls(cfg, device="meta")


def _batch_template(cfg: ModelConfig, sp: ShapeSpec, per_pod_batch: int,
                    device="meta", seed: int = 0):
    """{"tokens": (B, S + 1) int32 [, "src_emb": (B, S, d) float32]}:
    unfilled on the meta device, else drawn from `seed` (tokens uniform
    over the vocab, src_emb N(0, 1))."""
    b, s = per_pod_batch, sp.seq_len
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, dtype):
        if dev.type == "meta":
            return torch.empty(shape, dtype=dtype, device=dev)
        if dtype == torch.int32:
            t = torch.randint(0, cfg.vocab, shape, generator=gen,
                              dtype=dtype)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype)
        return t.to(dev)

    out = {"tokens": draw((b, s + 1), torch.int32)}
    if cfg.family == "encdec":
        out["src_emb"] = draw((b, s, cfg.d_model), torch.float32)
    return out


def _batch_shardings(mesh, cfg: ModelConfig, batch_tpl):
    bspec = batch_spec(mesh, batch_tpl["tokens"].shape[0])
    out = {"tokens": bspec}
    if "src_emb" in batch_tpl:
        out["src_emb"] = tuple(bspec)[:1] + (None, None)
    return out


def _setup(cfg, mesh, params, device, seed, dmesh, shards_only):
    """(model, build device, placer, the model's specs, home device) of
    a cell: the model placed by the rules.  Without `params` the model
    is drawn from `seed` on `device`, or is a meta template when
    `device` is meta or `shards_only`.  Arguments are built on the build
    device (meta for a template) and placed on the home device (`device`
    with `shards_only`, each rank's shards alone)."""
    dev = torch.device(device)
    if params is None:
        if dev.type == "meta" or shards_only:
            params = _param_template(cfg)
        else:
            init = (init_encdec_params if cfg.family == "encdec"
                    else init_lm_params)
            params = init(seed, cfg, dev)
    build = next(params.parameters()).device
    home = dev if shards_only else build
    if dmesh is None:
        dmesh = mesh.device_mesh("cuda" if home.type == "cuda" else "cpu")
    place = Placer(mesh, dmesh, dev if shards_only else None)
    specs = params_shardings(mesh, params)
    distribute_model(params, place, specs)
    return params, build, place, specs, home


def build_train_cell(arch: str, sp: ShapeSpec, mesh,
                     cfg: ModelConfig | None = None,
                     accum_steps: int | None = None,
                     unroll_accum: bool = False,
                     opt_cfg: adamw.AdamWConfig | None = None, *,
                     params=None, device="meta", seed: int = 0,
                     dmesh=None, shards_only: bool = False) -> CellSpec:
    """The train step on `sp.global_batch` x `sp.seq_len` tokens drawn
    from `seed`, from fresh optimizer and guard states.  The placement
    arguments as `build_cell` takes them."""
    cfg = cfg or get_config(arch)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if accum_steps is None:
        accum_steps = pick_accum_steps(mesh, sp.global_batch, sp.seq_len,
                                       cfg.d_model)
    micro_sh = None
    if accum_steps > 1:
        bspec = batch_spec(mesh, sp.global_batch // accum_steps)
        micro_sh = {"tokens": bspec}
        if cfg.family == "encdec":
            micro_sh["src_emb"] = (tuple(bspec)[0], None, None)
    step = make_train_step(cfg, opt_cfg, accum_steps, unroll_accum,
                           micro_shardings=micro_sh)

    model, build, place, p_sh, home = _setup(cfg, mesh, params, device,
                                             seed, dmesh, shards_only)
    opt = adamw.init(dict(model.named_parameters()), opt_cfg)
    guard = guard_init(GUARD_CFG, home)
    batch = _batch_template(cfg, sp, sp.global_batch, build, seed)
    b_sh = _batch_shardings(mesh, cfg, batch)
    batch = {n: place(v, b_sh[n]) for n, v in batch.items()}

    o_sh = adamw.OptState(m=p_sh, v=p_sh, count=())
    g_sh = tree_map(lambda _: (), guard)
    m_sh = {n: () for n in ("ce", "aux", "ppl_proxy", "loss", "grad_norm",
                            "lr", "skipped")}
    tokens = sp.global_batch * sp.seq_len
    if cfg.family == "encdec":
        tokens *= 2  # encoder + decoder sides
    return CellSpec(
        fn=on_dtensors(step), args=(model, opt, guard, batch),
        in_shardings=(p_sh, o_sh, g_sh, b_sh),
        out_shardings=(p_sh, o_sh, g_sh, m_sh),
        donate_argnums=(0, 1, 2),
        token_count=tokens,
    )


def build_prefill_cell(arch: str, sp: ShapeSpec, mesh,
                       cfg: ModelConfig | None = None, *, params=None,
                       device="meta", seed: int = 0, dmesh=None,
                       shards_only: bool = False) -> CellSpec:
    """The prompt's forward and the last position's logits, (B, vocab)
    float32 (the encoder-decoder: the source encoded, the target
    decoded); prompts drawn from `seed`.  The placement
    arguments as `build_cell` takes them."""
    cfg = cfg or get_config(arch)
    model, build, place, p_sh, _ = _setup(cfg, mesh, params, device, seed,
                                          dmesh, shards_only)
    b = sp.global_batch
    batch = _batch_template(cfg, sp, b, build, seed)

    if cfg.family == "encdec":
        def prefill(params, batch):
            with torch.no_grad():
                enc = encode(params, batch["src_emb"], cfg)
                hid = decode_train(params, enc, batch["tokens"][:, :-1],
                                   cfg, return_hidden=True)
                return unembed(params["embed"], hid[:, -1], cfg.vocab)
        b_sh = _batch_shardings(mesh, cfg, batch)
        arg = {n: place(v, b_sh[n]) for n, v in batch.items()}
    else:
        def prefill(params, tokens):
            # `lm_prefill` under no_grad in place of inference mode, in
            # which DTensor decomposes composite ops (einsum) in Python
            with torch.no_grad():
                x, _ = lm_backbone(params, tokens, cfg)
                return lm_logits(params, x[:, -1], cfg)
        b_sh = batch_spec(mesh, b)
        arg = place(batch["tokens"][:, :-1].contiguous(), b_sh)

    return CellSpec(fn=on_dtensors(prefill), args=(model, arg),
                    in_shardings=(p_sh, b_sh), out_shardings=None,
                    donate_argnums=(),
                    token_count=b * sp.seq_len * (
                        2 if cfg.family == "encdec" else 1))


def build_decode_cell(arch: str, sp: ShapeSpec, mesh,
                      cfg: ModelConfig | None = None, *, params=None,
                      device="meta", seed: int = 0, dmesh=None,
                      shards_only: bool = False) -> CellSpec:
    """One decode step of `sp.global_batch` tokens (drawn from `seed`)
    at position 0 over caches of `sp.seq_len` slots (zeroed;
    `cfg.kv_dtype`), written in place.  The placement
    arguments as `build_cell` takes them."""
    cfg = cfg or get_config(arch)
    model, build, place, p_sh, home = _setup(cfg, mesh, params, device,
                                             seed, dmesh, shards_only)
    b, s = sp.global_batch, sp.seq_len

    kvd = getattr(torch, cfg.kv_dtype)
    if cfg.family == "encdec":
        caches = init_encdec_cache(cfg, b, s, s, dtype=kvd, device=build)

        def step(params, token, pos, caches):
            with torch.no_grad():
                return encdec_decode_step(params, token, pos, caches, cfg)
    else:
        caches = init_cache(cfg, b, s, dtype=kvd, device=build)

        def step(params, token, pos, caches):
            with torch.no_grad():
                return lm_decode_step(params, token, pos, caches, cfg)

    c_sh = state_cache_shardings(mesh, caches)
    caches = tree_map(place, caches, c_sh)
    bspec = batch_spec(mesh, b, kind="decode")
    token = _batch_template(cfg, sp._replace(seq_len=0), b, build,
                            seed)["tokens"][:, 0].contiguous()
    token = place(token, bspec)
    pos = torch.zeros((), dtype=torch.int32, device=home)
    b_dim = tuple(bspec)[0] if len(tuple(bspec)) else None
    v_dim = "model" if cfg.vocab % dict(mesh.shape)["model"] == 0 else None
    return CellSpec(
        fn=on_dtensors(step), args=(model, token, pos, caches),
        in_shardings=(p_sh, bspec, (), c_sh),
        out_shardings=((b_dim, v_dim), c_sh),
        donate_argnums=(3,),
        token_count=b,
    )


def build_cell(arch: str, sp: ShapeSpec, mesh,
               cfg: ModelConfig | None = None,
               accum_steps: int | None = None,
               unroll_accum: bool = False,
               opt_cfg: adamw.AdamWConfig | None = None,
               **placed) -> CellSpec:
    """The cell of `sp.kind`.  `placed` goes to its builder: `params`
    (an `LM` or `EncDec`) has its parameters placed in place; without
    it the cell draws one from `seed` on `device` (a template on the
    meta device, the default).  With `shards_only` every argument is
    built on meta and this rank holds only its shards, zero-filled on
    `device` (one device's share of a production mesh: the local shapes
    are real, the values mean nothing).  `dmesh` reuses a DeviceMesh of
    `mesh`."""
    if sp.kind == "train":
        return build_train_cell(arch, sp, mesh, cfg, accum_steps,
                                unroll_accum, opt_cfg, **placed)
    if sp.kind == "prefill":
        return build_prefill_cell(arch, sp, mesh, cfg, **placed)
    if sp.kind == "decode":
        return build_decode_cell(arch, sp, mesh, cfg, **placed)
    raise ValueError(sp.kind)
