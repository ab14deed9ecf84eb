"""Mamba-1 language model (PyTorch): the mamba-130m stack with decoding.

Port of ``medical_image_classification_tpu/models/mamba_lm.py``:
``MambaConfig``, ``Mamba`` (the 1-D Mamba block: in_proj -> causal
depthwise conv1d + SiLU -> (Δ, B, C) projection -> selective scan with the
SiLU(z) gate -> out_proj, and ``step`` for one decode token),
``MambaLMBlock`` (pre-norm residual), ``MambaLMHeadModel`` (embedding ->
blocks -> final norm -> tied head, with ``init_cache`` and
``decode_step``) and ``generate``.

Parameters carry the names of the reference / HF ``state_dict``
(``backbone.embedding.weight``, ``backbone.layers.{i}.norm.weight``,
``backbone.layers.{i}.mixer.{in_proj,conv1d,x_proj,dt_proj,out_proj}.*``,
``...mixer.A_log``, ``...mixer.D``, ``backbone.norm_f.weight`` and
``lm_head.weight``, tied to the embedding), so the JAX package's
``import_mamba_lm_state_dict`` reads a port ``state_dict()`` and a
HF-format Mamba-1 ``state_dict`` loads with ``load_state_dict(strict=True)``
(one without ``lm_head.weight`` too: the head is the embedding).

Compute is fp32, as in the JAX module (it has no ``dtype``).  The
whole-sequence forward runs the selective scan through
``kernels/selective_scan.py::selective_scan`` (the folded CUDA kernel on
the card: one launch per layer); decoding runs ``selective_state_update``,
plain torch ops, as it is plain XLA in the JAX package.  The model is built
on the card unless the caller asks for the CPU, and raises if there is
none.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from medical_image_classification_tpu_torch.kernels.selective_scan import (
    selective_scan,
    selective_state_update,
)
from medical_image_classification_tpu_torch.models.common import (
    trunc_normal_02_,
)
from medical_image_classification_tpu_torch.models.ss2d_modules import (
    a_log_init_s4d_,
    dt_bias_init_,
    uniform_pm_,
)

# Flax's RMSNorm and LayerNorm eps; torch's defaults are finfo.eps and 1e-5
_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """``models/config_mamba.py:5-15``; the defaults are mamba-130m's."""
    d_model: int = 768
    n_layer: int = 24
    vocab_size: int = 50277
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    rms_norm: bool = True
    pad_vocab_size_multiple: int = 8

    @property
    def padded_vocab(self) -> int:
        """The embedding's rows: vocab_size rounded up to the multiple."""
        mult = self.pad_vocab_size_multiple
        return -(-self.vocab_size // mult) * mult


def _norm(d_model: int, rms_norm: bool) -> nn.Module:
    return (nn.RMSNorm(d_model, eps=_NORM_EPS) if rms_norm
            else nn.LayerNorm(d_model, eps=_NORM_EPS))


class Mamba(nn.Module):
    """1-D Mamba block (``mamba_simple.py:31-353``).  [B, L, d_model] in
    and out; ``step`` takes one token [B, d_model]."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: int | None = None,
                 bias: bool = False, conv_bias: bool = True,
                 scan_impl: str = "auto"):
        super().__init__()
        self.d_inner = d_inner = expand * d_model
        self.dt_rank = R = dt_rank or math.ceil(d_model / 16)
        self.d_state, self.d_conv = d_state, d_conv
        self.scan_impl = scan_impl
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=bias)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner,
                                bias=conv_bias)
        self.x_proj = nn.Linear(d_inner, R + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(R, d_inner)
        self.A_log = nn.Parameter(torch.empty(d_inner, d_state))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=bias)

    def reset_parameters(self, generator=None):
        """The JAX module's init: the projections trunc-normal(0.02) with
        zero biases, the conv kernel U(+-1/sqrt(d_conv)) with a zero bias,
        Δ's weight U(+-R^-0.5) and bias the softplus-inverse of a
        log-uniform draw in [0.001, 0.1], A_log = log(1..N), D = 1."""
        for lin in (self.in_proj, self.x_proj, self.out_proj):
            trunc_normal_02_(lin.weight, generator)
            if lin.bias is not None:
                nn.init.zeros_(lin.bias)
        uniform_pm_(self.conv1d.weight, 1.0 / math.sqrt(self.d_conv),
                    generator)
        if self.conv1d.bias is not None:
            nn.init.zeros_(self.conv1d.bias)
        uniform_pm_(self.dt_proj.weight, self.dt_rank ** -0.5, generator)
        dt_bias_init_(self.dt_proj.bias.data.view(1, -1), generator)
        a_log_init_s4d_(self.A_log)
        nn.init.ones_(self.D)

    def _x_dbc(self, xs):
        """The SiLU'd conv output -> (Δ before its bias, B, C)."""
        R, N = self.dt_rank, self.d_state
        dbl = self.x_proj(xs)
        return (F.linear(dbl[..., :R], self.dt_proj.weight),
                dbl[..., R:R + N], dbl[..., R + N:])

    def forward(self, x, return_state: bool = False):
        """[B, L, d_model] -> [B, L, d_model]; with ``return_state`` also
        the scan's last state [B, d_inner, d_state] fp32."""
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        # causal depthwise conv: k - 1 zeros on the left of time
        conv = F.conv1d(F.pad(xs.transpose(1, 2), (self.d_conv - 1, 0)),
                        self.conv1d.weight, self.conv1d.bias,
                        groups=self.d_inner)
        xs = F.silu(conv).transpose(1, 2)
        dt, Bm, Cm = self._x_dbc(xs)
        A = -torch.exp(self.A_log.float())
        out = selective_scan(xs, dt, A, Bm, Cm, D=self.D, z=z,
                             delta_bias=self.dt_proj.bias,
                             delta_softplus=True,
                             return_last_state=return_state,
                             impl=self.scan_impl)
        y, last = out if return_state else (out, None)
        y = self.out_proj(y.to(x.dtype))
        return (y, last) if return_state else y

    def step(self, x_t, conv_state, ssm_state):
        """One decode token.  x_t [B, d_model]; conv_state [B, d_conv - 1,
        d_inner]; ssm_state [B, d_inner, d_state].  Returns (y [B,
        d_model], the next conv_state, the next ssm_state)."""
        xs, z = self.in_proj(x_t).chunk(2, dim=-1)
        window = torch.cat([conv_state, xs[:, None]], dim=1)
        conv = torch.einsum("bkd,dk->bd", window, self.conv1d.weight[:, 0])
        if self.conv1d.bias is not None:
            conv = conv + self.conv1d.bias
        xs = F.silu(conv)
        dt, Bm, Cm = self._x_dbc(xs)
        A = -torch.exp(self.A_log.float())
        new_ssm, y = selective_state_update(
            ssm_state, xs, dt + self.dt_proj.bias, A, Bm, Cm, D=self.D, z=z,
            dt_softplus=True)
        return self.out_proj(y.to(x_t.dtype)), window[:, 1:], new_ssm


class MambaLMBlock(nn.Module):
    """Pre-norm residual block (``modules/mamba_simple.py:297`` Block)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, rms_norm: bool = True,
                 scan_impl: str = "auto"):
        super().__init__()
        self.norm = _norm(d_model, rms_norm)
        self.mixer = Mamba(d_model, d_state=d_state, d_conv=d_conv,
                           expand=expand, scan_impl=scan_impl)

    def forward(self, x):
        return x + self.mixer(self.norm(x))

    def step(self, x_t, conv_state, ssm_state):
        h, cs, ss = self.mixer.step(self.norm(x_t), conv_state, ssm_state)
        return x_t + h, cs, ss


class MixerModel(nn.Module):
    """The backbone: embedding, the blocks and the final norm (the
    reference's ``MixerModel``, whose name the ``backbone.`` keys carry)."""

    def __init__(self, cfg: MambaConfig, scan_impl: str = "auto"):
        super().__init__()
        self.embedding = nn.Embedding(cfg.padded_vocab, cfg.d_model)
        self.layers = nn.ModuleList(
            MambaLMBlock(cfg.d_model, d_state=cfg.d_state, d_conv=cfg.d_conv,
                         expand=cfg.expand, rms_norm=cfg.rms_norm,
                         scan_impl=scan_impl)
            for _ in range(cfg.n_layer))
        self.norm_f = _norm(cfg.d_model, cfg.rms_norm)


class MambaLMHeadModel(nn.Module):
    """``models/mixer_seq_simple.py:86,176``: token ids [B, L] -> logits
    [B, L, padded vocab] (fp32), the head tied to the embedding.

    ``scan_impl`` ("auto", "cuda", "torch", "seq" or "chunked") picks the
    selective scan of the whole-sequence forward (``selective_scan``).
    ``device`` is where the model lives ("cuda" unless the caller asks for
    the CPU; no card raises); ``generator`` (a CPU generator) seeds the
    init, which is drawn on the CPU and then moved."""

    def __init__(self, config: MambaConfig = MambaConfig(),
                 scan_impl: str = "auto", device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}, but torch sees no CUDA "
                               "device")
        self.config = config
        self.backbone = MixerModel(config, scan_impl)
        self.lm_head = nn.Linear(config.d_model, config.padded_vocab,
                                 bias=False)
        self.lm_head.weight = self.backbone.embedding.weight
        self.register_load_state_dict_pre_hook(self._tie_head)
        self.reset_parameters(generator)
        self.to(device)

    @staticmethod
    def _tie_head(module, state_dict, prefix, *args):
        """A ``state_dict`` without ``lm_head.weight`` (HF saves the tied
        head once) loads strictly: the head is the embedding."""
        head = prefix + "lm_head.weight"
        emb = prefix + "backbone.embedding.weight"
        if head not in state_dict and emb in state_dict:
            state_dict[head] = state_dict[emb]

    def reset_parameters(self, generator=None):
        """The JAX package's init: the embedding trunc-normal(0.02), each
        mixer its own (``Mamba.reset_parameters``), the norms (1, 0)."""
        trunc_normal_02_(self.backbone.embedding.weight, generator)
        for m in self.modules():
            if isinstance(m, Mamba):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.RMSNorm, nn.LayerNorm)):
                m.reset_parameters()

    def forward(self, input_ids):
        h = self.backbone.embedding(input_ids)
        for blk in self.backbone.layers:
            h = blk(h)
        return self.lm_head(self.backbone.norm_f(h))

    def init_cache(self, batch: int):
        """Zero decode caches: conv [n_layer, batch, d_conv - 1, d_inner]
        and ssm [n_layer, batch, d_inner, d_state], fp32."""
        cfg = self.config
        d_inner = cfg.expand * cfg.d_model
        dev = self.lm_head.weight.device
        return (torch.zeros(cfg.n_layer, batch, cfg.d_conv - 1, d_inner,
                            device=dev),
                torch.zeros(cfg.n_layer, batch, d_inner, cfg.d_state,
                            device=dev))

    def decode_step(self, token, cache):
        """token [B] (int) -> (logits [B, padded vocab], the next cache)."""
        conv, ssm = cache
        h = self.backbone.embedding(token)
        new_conv, new_ssm = [], []
        for i, blk in enumerate(self.backbone.layers):
            h, cs, ss = blk.step(h, conv[i], ssm[i])
            new_conv.append(cs)
            new_ssm.append(ss)
        logits = self.lm_head(self.backbone.norm_f(h))
        return logits, (torch.stack(new_conv), torch.stack(new_ssm))


def _sample(logits, temperature: float, top_k: int, generator):
    if temperature == 0.0:
        return logits.argmax(-1)
    lg = logits / temperature
    if top_k > 0:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate(model: MambaLMHeadModel, prompt_ids, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0,
             generator: torch.Generator | None = None):
    """Autoregressive generation (``generate`` of the JAX package,
    reference ``utils/generation.py:121-387``) on the model's device.

    The prompt runs through ``decode_step`` one token at a time, which
    keeps the conv and ssm caches exact; then each new token is sampled
    from the last logits: greedy at ``temperature`` 0, else softmax of
    logits / temperature, with every logit below the ``top_k``-th largest
    masked out when ``top_k`` > 0, sampled from ``generator`` (on the
    model's device; a fresh one seeded 0 if None).  prompt_ids [B, L0]
    int -> [B, L0 + max_new_tokens] (int64)."""
    dev = model.lm_head.weight.device
    prompt = torch.as_tensor(prompt_ids, device=dev).long()
    batch, L0 = prompt.shape
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = model.init_cache(batch)
    logits = torch.zeros(batch, model.config.padded_vocab, device=dev)
    for t in range(L0):
        logits, cache = model.decode_step(prompt[:, t], cache)
    new = []
    for i in range(max_new_tokens):
        new.append(_sample(logits, temperature, top_k, generator))
        if i + 1 < max_new_tokens:
            logits, cache = model.decode_step(new[-1], cache)
    if not new:
        return prompt
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1)
