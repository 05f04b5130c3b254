"""The plain references against independent forms: the convolution
against a loop over output positions, the TF32 rounding against its
definition, and the Qwen2 decode reference against a full forward pass
of a tiny Qwen2-shaped model over the whole sequence."""
from __future__ import annotations

import pathlib
import sys

import pytest
import torch
import torch.nn.functional as F

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from reference import conv2d as ref_conv  # noqa: E402
from reference import qwen2 as ref_lm  # noqa: E402
from setups import decoder_lm  # noqa: E402


@pytest.mark.parametrize("stride", [(1, 1), (2, 1)])
def test_conv_reference_against_a_loop(stride):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 3, 7, 6, generator=gen)
    w = torch.randn(5, 3, 3, 2, generator=gen)
    s_h, s_w = stride
    got = ref_conv.conv2d(x, w, s_h, s_w)
    h_out, w_out = (7 - 3) // s_h + 1, (6 - 2) // s_w + 1
    want = torch.zeros(4, 5, h_out, w_out, dtype=torch.float64)
    for i in range(h_out):
        for j in range(w_out):
            patch = x[:, :, i * s_h:i * s_h + 3, j * s_w:j * s_w + 2]
            want[:, :, i, j] = torch.einsum("nchw,kchw->nk",
                                            patch.double(), w.double())
    assert torch.allclose(got.double(), want, atol=1e-5)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12, 1.0 + 2 ** -11 + 2 ** -20])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 4 * 2 ** -11,
                         -3.0, 1.0 + 2 ** -10])
    assert torch.equal(ref_conv.round_tf32(x), want)
    gen = torch.Generator().manual_seed(4)
    y = torch.randn(1000, generator=gen)
    rel = ((ref_conv.round_tf32(y) - y) / y).abs().max().item()
    assert 2 ** -13 < rel <= 2 ** -11


def _full_forward(weights, m, tokens):
    """Every position of ``tokens`` (n, S) through the whole model at once,
    causal attention by ``F.scaled_dot_product_attention``: the logits
    and each layer's (k, v), keys rotated."""
    d, h, hk = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    dh, eps = d // h, m["rms_norm_eps"]
    n, s = tokens.shape
    pos = torch.arange(s)
    lay = weights["layers"]
    x = weights["embed"][tokens].float()
    kvs = []

    def norm(t, w):
        return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + eps) * w

    def rot(t):
        inv = 1.0 / m["rope_theta"] ** (torch.arange(0, dh, 2).float() / dh)
        ang = pos.float()[:, None] * inv[None]
        c, si = ang.cos()[None, :, None], ang.sin()[None, :, None]
        a, b = t[..., :dh // 2], t[..., dh // 2:]
        return torch.cat([a * c - b * si, b * c + a * si], -1)

    for i in range(m["num_hidden_layers"]):
        a = {k: v[i].float() for k, v in lay["attn"].items()}
        f = {k: v[i].float() for k, v in lay["ffn"].items()}
        xin = norm(x, lay["ln_attn"][i].float())
        q = rot((xin @ a["wq"] + a["bq"]).view(n, s, h, dh))
        k = rot((xin @ a["wk"] + a["bk"]).view(n, s, hk, dh))
        v = (xin @ a["wv"] + a["bv"]).view(n, s, hk, dh)
        kvs.append((k, v))
        rep = h // hk
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
            v.repeat_interleave(rep, 2).transpose(1, 2), is_causal=True)
        x = x + o.transpose(1, 2).reshape(n, s, d) @ a["wo"]
        xin = norm(x, lay["ln_mlp"][i].float())
        x = x + (F.silu(xin @ f["w_gate"]) * (xin @ f["w_up"])) @ f["w_down"]
    x = norm(x, weights["ln_f"].float())
    return x @ weights["lm_head"].float(), kvs


def test_qwen2_decode_reference_against_a_full_forward():
    m = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 128, "rope_theta": 1e6, "rms_norm_eps": 1e-6}
    weights = decoder_lm.make_weights(torch, m, torch.device("cpu"), 9)
    weights = {k: (v if isinstance(v, dict) else v.float())
               for k, v in weights.items()}
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(128, (3, 12), generator=gen)
    start = 8
    logits, kvs = _full_forward(weights, m, tokens)

    def init_kv(layer):
        k, v = kvs[layer]
        return k[:, :start], v[:, :start]

    got, ks, vs = ref_lm.forward(weights, m, init_kv, tokens[:, start:],
                                 start)
    assert torch.allclose(got, logits[:, start:], atol=1e-4, rtol=1e-4)
    for layer, (k, v) in enumerate(kvs):
        assert torch.allclose(ks[layer], k[:, start:], atol=1e-5)
        assert torch.allclose(vs[layer], v[:, start:], atol=1e-5)
    ctrl, _, _ = ref_lm.forward(weights, m, init_kv, tokens[:, start:],
                                start, quant="fp8")
    assert (ctrl - got).abs().max() > 1e-2
