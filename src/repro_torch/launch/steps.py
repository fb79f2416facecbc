"""Step artifacts of the port (``repro.launch.steps``): for every (arch x
assigned shape) cell, the step function, its abstract inputs (meta tensors,
never allocated) and each input's resolved spec on the production mesh.

  train_4k     -> train_step(params, opt_state, batch)
  prefill_32k  -> prefill_step(params, tokens[, frames], caches)
  decode_32k   -> serve_step(params, last_tokens, caches)   (one new token)
  long_500k    -> serve_step with a 524288-token state (SSM / hybrid only)

The specs are the reference's ``PartitionSpec`` trees in the port's tuple
form; :func:`materialize` turns the abstract inputs into DTensors on the
mesh (under a ``FakeTensorMode``, fake ones: the dry-run's inputs).  Each
step function installs its rules, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_abstract
from repro_torch.training.train_step import batch_axes, build_train_step, make_batch_abstract

BIG_PARAMS = 100e9  # >= 100B: bf16 Adam moments (the memory budget)


def make_rules(cfg: ModelConfig, mesh) -> sh.ShardingRules:
    return sh.ShardingRules(mesh).with_overrides(cfg.sharding_overrides)


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    big = cfg.approx_params() >= BIG_PARAMS
    return AdamWConfig(moment_dtype=torch.bfloat16 if big else torch.float32)


@dataclasses.dataclass
class StepArtifacts:
    """Everything one cell's step needs: the function, its abstract
    arguments and their specs (trees parallel to ``args``)."""

    fn: Callable
    args: tuple
    in_specs: tuple


def params_abstract(cfg: ModelConfig) -> dict:
    return sh.abstract_from_template(TF.param_template(cfg))


def input_specs(arch: str, shape: str) -> dict:
    """Meta-tensor stand-ins for every model input of a cell: no memory."""
    cfg = get_config(arch)
    sp = SHAPES[shape]
    if sp.kind == "train":
        return make_batch_abstract(cfg, sp.global_batch, sp.seq_len)
    if sp.kind == "prefill":
        out = {"tokens": torch.empty((sp.global_batch, sp.seq_len), dtype=torch.int32,
                                     device="meta")}
        if cfg.family in ("vlm", "encdec"):
            nf = cfg.n_frontend_tokens or 64
            out["frames"] = torch.empty((sp.global_batch, nf, cfg.d_model), dtype=cfg.dtype,
                                        device="meta")
        return out
    return {
        "last_tokens": torch.empty((sp.global_batch,), dtype=torch.int32, device="meta"),
        "caches": TF.init_caches(cfg, sp.global_batch, sp.seq_len, abstract=True),
    }


def _with_rules(rules: sh.ShardingRules, fn: Callable) -> Callable:
    """``fn`` under the rules, plain tensors it makes counting as replicated."""
    def step(*args):
        from torch.distributed.tensor.experimental import implicit_replication

        with sh.use_sharding_rules(rules), implicit_replication():
            return fn(*args)

    return step


def build_train_artifacts(cfg: ModelConfig, sp: ShapeSpec, rules: sh.ShardingRules) -> StepArtifacts:
    opt_cfg = opt_config_for(cfg)
    tmpl = TF.param_template(cfg)
    p_abs = sh.abstract_from_template(tmpl)
    p_spec = sh.specs_from_template(tmpl, rules)
    o_abs = adamw_abstract(p_abs, opt_cfg)
    o_spec = {"m": p_spec, "v": p_spec, "step": ()}
    b_abs = make_batch_abstract(cfg, sp.global_batch, sp.seq_len)
    b_spec = sh.specs_for_axes(b_abs, batch_axes(cfg), rules)
    return StepArtifacts(
        fn=_with_rules(rules, build_train_step(cfg, opt_cfg)),
        args=(p_abs, o_abs, b_abs),
        in_specs=(p_spec, o_spec, b_spec),
    )


def build_prefill_artifacts(cfg: ModelConfig, sp: ShapeSpec,
                            rules: sh.ShardingRules) -> StepArtifacts:
    tmpl = TF.param_template(cfg)
    p_spec = sh.specs_from_template(tmpl, rules)
    c_abs = TF.init_caches(cfg, sp.global_batch, sp.seq_len, abstract=True)
    c_spec = sh.specs_for_axes(c_abs, TF.cache_axes(cfg), rules)
    ins = input_specs(cfg.name, sp.name)
    tok_spec = rules.spec_for_shape(tuple(ins["tokens"].shape), ("batch", "seq"))
    args, in_specs = [sh.abstract_from_template(tmpl), ins["tokens"]], [p_spec, tok_spec]
    if "frames" in ins:
        args.append(ins["frames"])
        in_specs.append(rules.spec_for_shape(tuple(ins["frames"].shape),
                                             ("batch", "seq", "act_d_model")))

    def prefill_step(params, tokens, *rest):
        *frames, caches = rest
        return TF.prefill(cfg, params, tokens, caches, *frames)

    return StepArtifacts(
        fn=_with_rules(rules, prefill_step),
        args=(*args, c_abs),
        in_specs=(*in_specs, c_spec),
    )


def build_decode_artifacts(cfg: ModelConfig, sp: ShapeSpec,
                           rules: sh.ShardingRules) -> StepArtifacts:
    tmpl = TF.param_template(cfg)
    c_abs = TF.init_caches(cfg, sp.global_batch, sp.seq_len, abstract=True)
    c_spec = sh.specs_for_axes(c_abs, TF.cache_axes(cfg), rules)
    last = torch.empty((sp.global_batch,), dtype=torch.int32, device="meta")
    last_spec = rules.spec_for_shape((sp.global_batch,), ("batch",))

    def serve_step(params, last_tokens, caches):
        return TF.decode_step(cfg, params, last_tokens, caches)

    return StepArtifacts(
        fn=_with_rules(rules, serve_step),
        args=(sh.abstract_from_template(tmpl), last, c_abs),
        in_specs=(sh.specs_from_template(tmpl, rules), last_spec, c_spec),
    )


def build_cell(arch: str, shape: str, mesh) -> StepArtifacts:
    cfg = get_config(arch)
    sp = SHAPES[shape]
    rules = make_rules(cfg, mesh)
    if sp.kind == "train":
        return build_train_artifacts(cfg, sp, rules)
    if sp.kind == "prefill":
        return build_prefill_artifacts(cfg, sp, rules)
    if sp.kind in ("decode", "long_decode"):
        return build_decode_artifacts(cfg, sp, rules)
    raise ValueError(sp.kind)


def materialize(art: StepArtifacts, mesh, device: str | torch.device = "cpu") -> tuple:
    """The artifacts' arguments as uninitialised DTensors on ``mesh``, each
    holding only this rank's block (fake under a ``FakeTensorMode``)."""
    def one(t: torch.Tensor, spec: tuple) -> torch.Tensor:
        return sh.empty_sharded(tuple(t.shape), t.dtype, spec, mesh, torch.device(device))

    return tuple(sh.map_pair(one, a, s) for a, s in zip(art.args, art.in_specs))


def bytes_per_device(abstract: Any, specs: Any, mesh) -> int:
    """Bytes of this rank's blocks of an abstract tree under its specs."""
    total = 0

    def one(t: torch.Tensor, spec: tuple) -> None:
        nonlocal total
        block = sh.local_block(tuple(t.shape), mesh, sh.placements_for(spec, mesh, tuple(t.shape)))
        n = 1
        for b in block:
            n *= b.stop - b.start
        total += n * t.element_size()

    sh.map_pair(one, abstract, specs)
    return total
