"""The composable model behind the serving path, the counterpart of
``repro/models/model.py``: a repeating period of sublayers over
``num_layers // period`` groups with stacked parameters.

Three entry points:

- ``forward``      : full sequence (prefill), optional cache return
- ``decode_step``  : one token against a KV/SSM cache (serving)
- ``encode``       : whisper's encoder (frame embeddings -> memory)

The reference's ``lax.scan`` over groups is a Python loop over the stacked
groups.  Caches keep the reference's layout (a leading group dim, then
the sublayer index, then the batch) so a request's cache splices into a
batch slot the same way.  Mixture-of-experts FFNs (mixtral, qwen3-moe,
jamba's odd positions) sit where ``cfg.layer_uses_moe``; ``forward``
returns their balance loss summed over layers, ``decode_step`` drops it.
An encoder-decoder config (whisper) takes absolute sinusoidal positions
in place of RoPE and a cross-attention sublayer after each
self-attention, its K/V of the encoder output cached as ``ck``/``cv``.
A vision-prefix config (paligemma) projects the batch's patch embeddings
into ``P`` prefix positions before the text, attended to bidirectionally
(the prefix-LM mask) in the prefill.

With ``rules`` whose mesh is bound to ranks (``launch.mesh.init_mesh``),
the model holds this rank's shards of the parameters, cut by
:func:`pspecs` (the reference's specs, ``sharding/place.py``), and runs
the reference's tensor- and expert-parallel plan with explicit
collectives (``sharding/collectives.py``; the sublayer modules say
which): the inputs are the whole batch's, as ``launch.inputs`` gives
them; the rank computes its block of the batch (the data axes' block
where the batch divides them, all of it otherwise) and returns that
block's logits, every vocab entry (a vocab-sharded embedding is a masked
lookup all-reduced over ``model``, a vocab-sharded head's logits are
all-gathered), and its shards of the cache in :func:`cache_pspecs`'s
layout.  Two of the reference's paths raise ``NotImplementedError``
(:func:`check_runnable`): sequence-parallel attention
(``rules.seq_axis``) and the context-parallel decode cache, where the KV
heads do not divide ``model`` and :func:`cache_pspecs` splits the
cache's sequence dim instead.  The sharded path infers only: its
collectives have no backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import mamba as M
from repro_torch.models.layers import norm, sinusoidal_rows
from repro_torch.models.params import (ParamDesc, ParamTree, check_tree,
                                       init_params, local_descs,
                                       param_pspecs, param_shapes, stack_tree)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.place import (batch_block, batch_sharded,
                                        local_shape, shard_tree)
from repro_torch.sharding.specs import AxisRules, P, batch_axes

Tree = Any


def vocab_axis(cfg: ArchConfig, rules: AxisRules) -> Optional[str]:
    """The axis the vocab dim of ``embed`` / ``lm_head`` splits over."""
    tp = rules.tensor_axis
    return tp if rules.mesh is None or rules.divisible(cfg.vocab, tp) \
        else None


def param_descs(cfg: ArchConfig, rules: Optional[AxisRules] = None) -> Tree:
    """The model's parameter descriptors, named, shaped and partitioned as
    the reference's ``Model.param_descs`` under ``rules`` (groups stacked
    on a leading dim)."""
    rules = rules or AxisRules()
    n_groups = cfg.num_layers // len(cfg.layer_period)
    encdec = cfg.encoder is not None
    vshard = vocab_axis(cfg, rules)
    descs: Dict[str, Any] = {
        "embed": ParamDesc((cfg.vocab, cfg.d_model), pspec=P(vshard, None)),
        "groups": stack_tree(B.sublayer_descs(cfg, rules, with_cross=encdec),
                             n_groups),
        "final_norm": B.norm_descs(cfg),
    }
    if not cfg.tie_embeddings:
        descs["lm_head"] = ParamDesc((cfg.d_model, cfg.vocab),
                                     pspec=P(None, vshard))
    if cfg.vision is not None:
        descs["vision_proj"] = ParamDesc((cfg.vision.embed_dim, cfg.d_model),
                                         pspec=P(None, None))
    if encdec:
        layer = {"attn_norm": B.norm_descs(cfg),
                 "attn": A.attn_param_descs(cfg, rules),
                 "ffn_norm": B.norm_descs(cfg),
                 "ffn": B.mlp_param_descs(cfg, rules)}
        descs["encoder"] = {
            "layers": stack_tree(layer, cfg.encoder.num_layers),
            "final_norm": B.norm_descs(cfg)}
    return descs


def pspecs(cfg: ArchConfig, rules: Optional[AxisRules] = None) -> Tree:
    """The parameters' partition specs (the reference's
    ``Model.pspecs``)."""
    return param_pspecs(param_descs(cfg, rules))


def cache_pspecs(cfg: ArchConfig, rules: AxisRules, batch: int,
                 seq_len: int) -> Dict[str, P]:
    """Sharding of the decode cache (the reference's
    ``Model.cache_pspecs``).  KV heads shard over ``model`` when
    divisible; otherwise the cache's sequence dim is context-parallel
    over ``model`` (and over the data axes too when the batch cannot
    shard), which this port does not run yet."""
    tp = rules.tensor_axis
    C_len = A.kv_cache_len(cfg, seq_len)
    b_ok = batch_sharded(rules, batch)
    bs = batch_axes(rules) if b_ok else None
    kvs = tp if (rules.mesh is None or
                 rules.divisible(max(cfg.num_kv_heads, 1), tp)) else None
    if kvs is not None:
        seq_s = None
    else:
        cand = tp if b_ok else (tuple(rules.data_axes) + (tp,))
        seq_s = cand if (rules.mesh is None or
                         C_len % max(rules.axis_size(cand), 1) == 0) else None
    specs = {"pos": P(bs)}
    if "attn" in cfg.layer_period:
        specs["k"] = P(None, None, bs, seq_s, kvs, None)
        specs["v"] = P(None, None, bs, seq_s, kvs, None)
    if "mamba" in cfg.layer_period:
        specs["h"] = P(None, None, bs, tp, None)
        specs["conv"] = P(None, None, bs, None, tp)
    if cfg.encoder is not None and "attn" in cfg.layer_period:
        specs["ck"] = P(None, None, bs, None, kvs, None)
        specs["cv"] = P(None, None, bs, None, kvs, None)
    return specs


def check_runnable(cfg: ArchConfig, rules: AxisRules,
                   batch: Optional[int] = None,
                   seq_len: Optional[int] = None) -> None:
    """Raise ``NotImplementedError`` for the reference's paths this port
    does not run yet: sequence-parallel attention (``rules.seq_axis``),
    and, given a cache's batch and length, the context-parallel decode
    cache."""
    if rules.seq_axis is not None:
        raise NotImplementedError(
            f"{cfg.name}: sequence-parallel attention (rules.seq_axis="
            f"{rules.seq_axis!r}, the reference's Model._attn_seq_parallel) "
            f"is the next sharding slice")
    if batch is not None and "k" in (specs := cache_pspecs(
            cfg, rules, batch, seq_len)) and specs["k"][3] is not None \
            and rules.axis_size(specs["k"][3]) > 1:
        raise NotImplementedError(
            f"{cfg.name}: the context-parallel decode cache (cache_pspecs "
            f"splits the cache's sequence dim over {specs['k'][3]!r}: "
            f"{cfg.num_kv_heads} KV heads do not divide "
            f"{rules.tensor_axis!r}) is the next sharding slice")


def model_shapes(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16
                 ) -> Tree:
    """The parameter tree of :func:`param_descs` as ``meta`` tensors of
    ``dtype`` (the reference's ``Model.shapes``), allocating nothing."""
    return param_shapes(param_descs(cfg), dtype)


def cache_shapes(cfg: ArchConfig, batch: int, seq_len: int, *,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The decode cache for ``batch`` sequences of ``seq_len`` positions as
    ``meta`` tensors, in the reference's layout and keys: ``pos`` (B,)
    int32; ``k``/``v`` (G, na, B, C, KH, hd) with C = ``kv_cache_len``;
    the SSM state ``h`` (G, nm, B, d_in, N) in float32 and the conv
    window ``conv`` (G, nm, B, d_conv - 1, d_in); an encoder-decoder's
    ``ck``/``cv`` (G, na, B, src_len, KH, hd).  All but ``pos`` and ``h``
    in ``dtype``."""
    g = cfg.num_layers // len(cfg.layer_period)
    na = sum(k == "attn" for k in cfg.layer_period)
    nm = len(cfg.layer_period) - na

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    shapes = {"pos": meta((batch,), torch.int32)}
    if na:
        kv = (g, na, batch, A.kv_cache_len(cfg, seq_len),
              max(cfg.num_kv_heads, 1), cfg.hd)
        shapes["k"], shapes["v"] = meta(kv), meta(kv)
    if nm:
        state = M.mamba_state_shapes(cfg, batch)
        shapes["h"] = meta((g, nm) + state["h"], torch.float32)
        shapes["conv"] = meta((g, nm) + state["conv"])
    if cfg.encoder is not None and na:
        cross = kv[:3] + (cfg.encoder.src_len,) + kv[4:]
        shapes["ck"], shapes["cv"] = meta(cross), meta(cross)
    return shapes


# the reference's decode-step table has this many rows and is indexed by
# ``pos`` as jnp indexes: a negative row counts from the end, a row past
# the end reads the last
PE_ROWS = 1 << 16


def decode_positions(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """The absolute position rows a decode step adds: (B, dim) float32,
    the rows of the reference's ``sinusoidal_positions(PE_ROWS, dim)[pos]``
    computed directly (an empty slot's pos = -1 reads the last row)."""
    row = torch.where(pos < 0, pos + PE_ROWS, pos).clamp(0, PE_ROWS - 1)
    return sinusoidal_rows(row, dim)


def _groups(tree: Tree, n: int) -> list:
    """The ``n`` groups of a stacked parameter tree, each a tree of views,
    by one ``unbind`` a leaf: under grad the groups' gradients are then
    stacked back once, where taking one group at a time by indexing would
    scatter each group's gradient into a zeroed tensor of the stacked
    size and add it in, a cost quadratic in the depth."""
    if isinstance(tree, dict):
        per_key = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in per_key.items()} for g in range(n)]
    return list(tree.unbind(0))


class Model(nn.Module):
    """An LM (attention, Mamba or a period of both; dense or
    mixture-of-experts FFNs; decoder-only, for paligemma behind a vision
    prefix, or, for whisper, behind an encoder) holding its parameters.
    ``params`` (a nested dict of tensors shaped as :func:`param_descs`;
    on a bound mesh, this rank's shards of them) is used as given;
    otherwise float32 parameters are drawn from ``generator``, on its
    device (on a mesh the whole tree, then cut to this rank's shards, so
    every rank and the unsharded model draw the same weights)."""

    def __init__(self, cfg: ArchConfig, rules: Optional[AxisRules] = None,
                 *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Tree] = None):
        super().__init__()
        self.device = resolve_device(device)
        p_len = len(cfg.layer_period)
        if cfg.num_layers % p_len:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers, period "
                             f"{p_len}")
        self.cfg = cfg
        self.rules = rules or AxisRules()
        check_runnable(cfg, self.rules)
        self._runnable: set = set()
        mesh = self.rules.mesh
        if mesh is not None and not mesh.bound:
            raise ValueError(f"{cfg.name}: Model needs a mesh bound to ranks "
                             f"(launch.mesh.init_mesh); this one is abstract "
                             f"(its specs: models.model.pspecs)")
        self.period = cfg.layer_period
        self.n_groups = cfg.num_layers // p_len
        self.attn_pos = [i for i, k in enumerate(self.period) if k == "attn"]
        self.mamba_pos = [i for i, k in enumerate(self.period) if k == "mamba"]
        # whisper: absolute sinusoidal positions, no RoPE
        self.is_encdec = cfg.encoder is not None
        self.use_rope = not self.is_encdec
        descs = param_descs(cfg, self.rules)
        if params is None:
            if generator is None:
                raise ValueError("Model: give params or a generator")
            params = init_params(descs, generator)
            if mesh is not None:
                params = shard_tree(params, descs, mesh, mesh.coord)
        check_tree(local_descs(descs, mesh), params)
        self.params = ParamTree(params).to(self.device)

    # ------------------------------------------------------------------
    # Sharding
    # ------------------------------------------------------------------

    def pspecs(self) -> Tree:
        return pspecs(self.cfg, self.rules)

    def cache_pspecs(self, batch: int, seq_len: int) -> Dict[str, P]:
        return cache_pspecs(self.cfg, self.rules, batch, seq_len)

    def _check_cache(self, batch: int, seq_len: int) -> None:
        """:func:`check_runnable` for a cache of ``batch`` sequences of
        ``seq_len`` on the mesh, once a size."""
        if (batch, seq_len) not in self._runnable:
            check_runnable(self.cfg, self.rules, batch, seq_len)
            self._runnable.add((batch, seq_len))

    def _block(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's block of a whole batch's input."""
        if x is None or self.rules.mesh is None:
            return x
        return x[batch_block(self.rules, x.shape[0])]

    def _split(self, batch: int) -> bool:
        """Whether a batch of ``batch`` splits over the data axes."""
        return batch_sharded(self.rules, batch)

    def _embed(self, p: Tree, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings; a vocab-sharded table is a masked lookup
        of this rank's rows, all-reduced over the tensor axis."""
        n = self.rules.axis_size(self.rules.tensor_axis)
        if vocab_axis(self.cfg, self.rules) is None or n == 1:
            return F.embedding(tokens, p["embed"])
        rows = p["embed"].shape[0]
        local = tokens - C.axis_index(self.rules, self.rules.tensor_axis) * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), p["embed"])
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        return C.all_reduce_sum(x, self.rules, self.rules.tensor_axis)

    # ------------------------------------------------------------------
    # Encoder (whisper)
    # ------------------------------------------------------------------

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, src_len, d_model) precomputed conv/mel embeddings
        -> the encoder's output, same shape (on a mesh, this rank's block
        of the batch): sinusoidal positions, then pre-norm layers of
        non-causal self-attention (no RoPE, no window) and the FFN, then
        the final norm."""
        return self._encode(self._block(frames))

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        cfg, rules = self.cfg, self.rules
        enc = self.params.tree()["encoder"]
        src_len = frames.shape[1]
        positions = torch.arange(src_len, device=frames.device)
        x = frames + sinusoidal_rows(positions, cfg.d_model).to(frames.dtype)
        for lp in _groups(enc["layers"], cfg.encoder.num_layers):
            h = norm(x, lp["attn_norm"], cfg.norm_kind, cfg.norm_eps)
            y, _ = A.attn_forward(lp["attn"], h, positions, cfg,
                                  causal=False, use_rope=False, rules=rules)
            x = x + y
            h = norm(x, lp["ffn_norm"], cfg.norm_kind, cfg.norm_eps)
            x = x + B.mlp_forward(lp["ffn"], h, cfg, rules)
        return norm(x, enc["final_norm"], cfg.norm_kind, cfg.norm_eps)

    # ------------------------------------------------------------------
    # Forward (prefill)
    # ------------------------------------------------------------------

    def forward(self, tokens: torch.Tensor, *,
                patches: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None,
                return_cache: bool = False,
                cache_len: Optional[int] = None,
                last_logit_only: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tree]]:
        """tokens: (B, S_text); patches: (B, P, embed_dim), required by a
        vision config, projected into P positions before the text;
        frames: (B, src_len, d_model), required by an encoder-decoder and
        encoded first.  Returns (logits (B, S, V), moe_aux, cache) with
        S = P + S_text: the cache's slots hold the last ``cache_len``
        (default S) of the S positions, its ``pos`` is S.  On a mesh the
        inputs are the whole batch's and the logits and cache this rank's
        (module docstring)."""
        cfg, rules = self.cfg, self.rules
        p = self.params.tree()
        batch = tokens.shape[0]
        split = self._split(batch)
        if return_cache and rules.mesh is not None:
            n_pos = tokens.shape[1] + (0 if patches is None
                                       else patches.shape[1])
            self._check_cache(batch, cache_len or n_pos)
        tokens, patches, frames = (self._block(t)
                                   for t in (tokens, patches, frames))
        x = self._embed(p, tokens)
        prefix_len = 0
        if cfg.vision is not None:
            if patches is None:
                raise ValueError(f"{cfg.name}: forward needs patches, the "
                                 f"vision prefix's input")
            pre = torch.einsum("bpe,ed->bpd", patches.to(x.dtype),
                               p["vision_proj"])
            x = torch.cat([pre, x], dim=1)
            prefix_len = patches.shape[1]
        elif patches is not None:
            raise ValueError(f"{cfg.name}: patches given to a config "
                             f"without a vision prefix")
        enc_out = None
        if self.is_encdec:
            if frames is None:
                raise ValueError(f"{cfg.name}: forward needs frames, the "
                                 f"encoder's input")
            enc_out = self._encode(frames)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        if self.is_encdec:
            x = x + sinusoidal_rows(positions, cfg.d_model).to(x.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys: Dict[str, list] = {"k": [], "v": [], "h": [], "conv": [],
                               "ck": [], "cv": []}
        for gp in _groups(p["groups"], self.n_groups):
            new: Dict[str, list] = {k: [] for k in ys}
            for i, kind in enumerate(self.period):
                sub = gp[f"pos{i}"]
                h = norm(x, sub["mixer_norm"], cfg.norm_kind, cfg.norm_eps)
                if kind == "attn":
                    y, (k, v) = A.attn_forward(sub["mixer"], h, positions,
                                               cfg, use_rope=self.use_rope,
                                               prefix_len=prefix_len,
                                               rules=rules)
                    new["k"].append(k)
                    new["v"].append(v)
                    x = x + y
                    if self.is_encdec:
                        h = norm(x, sub["cross_norm"], cfg.norm_kind,
                                 cfg.norm_eps)
                        cc = A.cross_attn_cache(sub["cross"], enc_out, cfg,
                                                rules)
                        x = x + A.cross_attn_forward(sub["cross"], h, cc,
                                                     cfg, rules)
                        new["ck"].append(cc["k"])
                        new["cv"].append(cc["v"])
                else:
                    y, (hl, cs) = M.mamba_forward(sub["mixer"], h, cfg,
                                                  return_state=True,
                                                  rules=rules)
                    new["h"].append(hl)
                    new["conv"].append(cs)
                    x = x + y
                x, a = B.apply_ffn(sub, x, cfg, i, rules, batch_split=split)
                aux = aux + a
            if return_cache:
                for k2, v2 in new.items():
                    if v2:
                        ys[k2].append(torch.stack(v2))
        x = norm(x, p["final_norm"], cfg.norm_kind, cfg.norm_eps)
        if last_logit_only:
            x = x[:, -1:]     # prefill: only the next-token logits matter
        logits = self._lm_head(p, x)
        cache = None
        if return_cache:
            stacked = {k2: torch.stack(v2) for k2, v2 in ys.items() if v2}
            cache = self._build_cache(stacked, S, cache_len, x.shape[0])
        return logits, aux, cache

    def _lm_head(self, p: Tree, x: torch.Tensor) -> torch.Tensor:
        w = p.get("lm_head")
        if w is None:
            w = p["embed"].T
        logits = x @ w
        if vocab_axis(self.cfg, self.rules) is None:
            return logits
        return C.all_gather(logits, self.rules, self.rules.tensor_axis, -1)

    # ------------------------------------------------------------------
    # Cache
    # ------------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        return A.kv_cache_len(self.cfg, seq_len)

    def shapes(self, dtype: torch.dtype = torch.bfloat16) -> Tree:
        return model_shapes(self.cfg, dtype)

    def cache_shapes(self, batch: int, seq_len: int, *,
                     dtype: torch.dtype = torch.bfloat16) -> Dict:
        return cache_shapes(self.cfg, batch, seq_len, dtype=dtype)

    def init_cache(self, batch: int, seq_len: int, *,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """An empty decode cache shaped as :func:`cache_shapes` (on a
        mesh, this rank's shards of it): ``pos`` -1, every state 0.  K/V,
        ``ck``/``cv`` and the conv window in ``dtype`` (default: the
        parameters' type; the reference defaults to bfloat16), the SSM
        state in float32."""
        rules = self.rules
        if rules.mesh is not None:
            self._check_cache(batch, seq_len)
        dtype = dtype or self.params.tree()["embed"].dtype
        specs = self.cache_pspecs(batch, seq_len)
        cache = {k: torch.zeros(
            m.shape if rules.mesh is None else
            local_shape(m.shape, specs[k], rules.mesh),
            dtype=m.dtype, device=self.device)
            for k, m in cache_shapes(self.cfg, batch, seq_len,
                                     dtype=dtype).items()}
        cache["pos"].fill_(-1)
        return cache

    def _build_cache(self, ys: Dict[str, torch.Tensor], S: int,
                     cache_len: Optional[int], batch: int) -> Dict:
        """Turn the collected full-sequence K/V and states into a decode
        cache of ``cache_len(cache_len or S)`` slots."""
        C_len = self.cache_len(cache_len or S)
        cache: Dict[str, torch.Tensor] = {}
        if "k" in ys:
            k, v = ys["k"], ys["v"]       # (G, na, B, S, KH, hd)
            if S > C_len:                  # keep last C (rotating slots)
                slots = torch.arange(S - C_len, S, device=k.device) % C_len
                order = torch.argsort(slots)
                k = k[:, :, :, S - C_len:].index_select(3, order)
                v = v[:, :, :, S - C_len:].index_select(3, order)
            elif S < C_len:
                pad = (0, 0, 0, 0, 0, C_len - S)
                k, v = F.pad(k, pad), F.pad(v, pad)
            cache["k"], cache["v"] = k, v
        if "h" in ys:
            cache["h"] = ys["h"].float()
            cache["conv"] = ys["conv"]
        if "ck" in ys:
            cache["ck"], cache["cv"] = ys["ck"], ys["cv"]
        cache["pos"] = torch.full((batch,), S, dtype=torch.int32,
                                  device=self.device)
        return cache

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens: (B, 1) -> (logits (B, V), cache).  The cache's tensors
        are updated in place (the reference returns a new pytree) and the
        same dict is returned, its ``pos`` advanced by one.  An
        encoder-decoder's ``ck``/``cv`` are read, never written.  On a
        mesh ``cache`` is this rank's (as ``forward`` or ``init_cache``
        gave it, in :func:`cache_pspecs`'s layout), ``tokens`` the whole
        batch's, and the logits this rank's block's."""
        cfg, rules = self.cfg, self.rules
        p = self.params.tree()
        pos = cache["pos"]                                  # (B,)
        split = True
        if rules.mesh is not None:
            batch = tokens.shape[0]
            split = self._split(batch)
            self._check_cache(batch, cache["k"].shape[3] if "k" in cache
                              else 1)
            tokens = self._block(tokens)
        x = self._embed(p, tokens)
        if self.is_encdec:
            x = x + decode_positions(pos, cfg.d_model)[:, None].to(x.dtype)
        for gi, gp in enumerate(_groups(p["groups"], self.n_groups)):
            ia = im = 0
            for i, kind in enumerate(self.period):
                sub = gp[f"pos{i}"]
                h = norm(x, sub["mixer_norm"], cfg.norm_kind, cfg.norm_eps)
                if kind == "attn":
                    y, _, _ = A.attn_decode_step(
                        sub["mixer"], h, pos, cache["k"][gi, ia],
                        cache["v"][gi, ia], cfg, use_rope=self.use_rope,
                        rules=rules)
                    x = x + y
                    if self.is_encdec:
                        h = norm(x, sub["cross_norm"], cfg.norm_kind,
                                 cfg.norm_eps)
                        x = x + A.cross_attn_decode(
                            sub["cross"], h, {"k": cache["ck"][gi, ia],
                                              "v": cache["cv"][gi, ia]},
                            cfg, rules)
                    ia += 1
                else:
                    y, hn, cn = M.mamba_decode_step(
                        sub["mixer"], h, cache["h"][gi, im],
                        cache["conv"][gi, im], cfg, rules)
                    cache["h"][gi, im] = hn
                    cache["conv"][gi, im] = cn
                    im += 1
                    x = x + y
                x, _ = B.apply_ffn(sub, x, cfg, i, rules, batch_split=split)
        x = norm(x, p["final_norm"], cfg.norm_kind, cfg.norm_eps)
        logits = self._lm_head(p, x)[:, 0]
        cache["pos"] = pos + 1
        return logits, cache
