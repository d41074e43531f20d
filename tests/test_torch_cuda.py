"""The port's CUDA kernels and its serving slice on the card.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time). On a machine with the card:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

builds the kernels (``nvcc``, ``sm_90a``) and holds each against its plain
version on the same inputs: flash attention to 1e-5 in float32 and 2.5e-2
in bf16 (the reference tests' bounds; bf16 at head_dim 64 and 128 runs the
tensor-core kernel, the rest the CUDA-core one), the log-sum-exp that both
forward kernels store to 1e-4 (float32 sums in another order, and
ex2.approx in the tensor-core kernel, on values of order 1-10), the flash
backward to 1e-5 (float32) and 1e-2 (bf16, gradients rounded to bf16: 3.9e-3
of a value) of each gradient's largest value, bit-identical from call to
call on the tensor-core route, block delta (cluster and
two-pass kernels) with q equal as int8, scale and the dirty flag equal and
norm2 to rtol 1e-5 (sums in another order; NaN equal), the selective
scan to 2e-4 in float32 and 1e-1 in bf16 on y (tests/kernels/test_ssm_scan.py)
and to 2e-4 on the last state and the chunk states it saves for training,
and the scan backward to 1e-4 of each gradient's largest value (2e-2 for dx
when x is bf16), bit-identical from call to call. The reduced train steps
of qwen2-1.5b, hymba-1.5b and falcon-mamba-7b on the card (kernels in both
directions) match the same steps on the CPU, and so do the reduced MoE
configs' serving computations and train steps (qwen3-moe-30b-a3b,
mixtral-8x7b; routing and dispatch are plain PyTorch on both), the reduced
internvl2-76b (pixel embeds before the prompt; ``remat_policy="dots"``)
and musicgen-large, and decode with the int8 KV cache.
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import flat_tensors
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels.block_delta import ops as bd_ops
from repro_torch.kernels.block_delta.ref import block_delta_flat_ref, block_delta_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.kernels.ssm_scan.ref import selective_scan_bwd_ref, selective_scan_ref
from repro_torch.launch import serve
from repro_torch.configs.base import ShapeCell
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_model
from repro_torch.models.runtime import CellPlan, make_train_step
from repro_torch.optim import adamw
from repro_torch.state.checkpoint import dirty_block_indices, exact_dirty_blocks

FLASH_CASES = [  # tests/kernels/test_flash_attention.py, then ragged / small heads
    (2, 256, 4, 2, 64, True, 0),
    (2, 256, 4, 4, 64, True, 0),
    (1, 512, 8, 2, 128, True, 0),
    (2, 256, 4, 1, 64, True, 0),
    (2, 256, 4, 2, 64, False, 0),
    (2, 512, 4, 2, 64, True, 128),
    (1, 512, 2, 2, 64, True, 256),
    (1, 384, 4, 2, 64, True, 0),
    (2, 100, 4, 2, 16, True, 0),
    (1, 77, 2, 1, 32, False, 0),
    (4, 512, 12, 2, 128, True, 0),     # qwen2-1.5b prefill, one layer
    (4, 512, 32, 4, 128, True, 0),     # qwen3-moe-30b-a3b prefill, one layer: G 8
    (4, 768, 64, 8, 128, True, 0),     # internvl2-76b: 256 pixel embeds + 512 tokens, G 8
    (4, 512, 32, 32, 64, True, 0),     # musicgen-large: MHA, G 1
]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.5e-2}
SCAN_CASES = [  # tests/kernels/test_ssm_scan.py, then ragged / other state sizes
    (2, 64, 32, 8),
    (1, 128, 64, 16),
    (2, 96, 32, 8),
    (1, 64, 128, 16),
    (3, 33, 100, 16),
    (1, 17, 5, 32),
    (2, 40, 77, 4),
    (4, 512, 3200, 16),                # hymba-1.5b prefill, one layer
]
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, hd, causal, window, dtype):
    g = torch.Generator(device=cuda).manual_seed(42)
    q = torch.randn(B, H, S, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, generator=g, device=cuda).to(dtype)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err < TOL[dtype], err


SM90_GROUPS = [(2, 2), (4, 2), (10, 2), (12, 2)]     # H, KV: groups 1, 2, 5, 6
SM90_MASKS = [(True, 0), (False, 0), (True, 128), (True, 256), (False, 128)]


@pytest.mark.parametrize("causal,window", SM90_MASKS)
@pytest.mark.parametrize("H,KV", SM90_GROUPS)
@pytest.mark.parametrize("S", [1, 40, 384, 520])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_sm90_kernel_matches_plain(cuda, hd, S, H, KV, causal, window):
    """The tensor-core kernel (bf16, hd 64/128) at ragged lengths, GQA groups
    and masks, against the plain version to the bf16 bound."""
    g = torch.Generator(device=cuda).manual_seed(S * 131 + H)
    q = torch.randn(2, H, S, hd, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, KV, S, hd, generator=g, device=cuda).bfloat16()
    v = torch.randn(2, KV, S, hd, generator=g, device=cuda).bfloat16()
    before = fa_ops.flash_attention.launches_sm90
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches_sm90 == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err < TOL[torch.bfloat16], err


@pytest.mark.parametrize("dtype,hd,kernel", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
])
def test_flash_launch_goes_to_the_kernel_of_its_type(cuda, dtype, hd, kernel):
    q = torch.randn(1, 4, 128, hd, device=cuda).to(dtype)
    k = torch.randn(1, 2, 128, hd, device=cuda).to(dtype)
    fa = fa_ops.flash_attention
    before = (fa.launches, fa.launches_sm90, fa.launches_simt)
    fa(q, k, k)
    torch.cuda.synchronize()
    after = (fa.launches, fa.launches_sm90, fa.launches_simt)
    sm90 = int(kernel == "sm90")
    assert after == (before[0] + 1, before[1] + sm90, before[2] + 1 - sm90)


def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 2, 64, 48, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q[:, :1], q[:, :1])


BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BWD_CASES = FLASH_CASES + [(4, 512, 25, 5, 64, True, 2048)]   # + hymba-1.5b's shape


def _bwd_inputs(B, S, H, KV, hd, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(*shape, generator=g, device=device).to(dtype)
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd), (B, H, S, hd))]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_bwd_kernel_matches_plain(cuda, B, S, H, KV, hd, causal, window, dtype):
    """The backward on the route of its (dtype, head_dim) (bf16 at 64 and
    128 on the tensor cores: the JAX kernel tests' cases of those head dims
    and both training shapes), fed the output and lse of the forward kernel,
    against the plain backward at that output."""
    q, k, v, do = _bwd_inputs(B, S, H, KV, hd, dtype, 5, cuda)
    o, lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    fb = fa_ops.flash_attention_bwd
    before = (fb.launches, fb.launches_sm90, fb.launches_simt)
    got = fb(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    sm90 = int(fa_ops.uses_sm90_bwd(dtype, hd, H // KV))
    assert (fb.launches, fb.launches_sm90, fb.launches_simt) == (
        before[0] + 1, before[1] + sm90, before[2] + 1 - sm90)
    want = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    for name, gg, ww in zip("qkv", got, want):
        assert gg.dtype == dtype and gg.shape == ww.shape, name
        assert bool(torch.isfinite(gg.float()).all()), name
        assert _rel(gg, ww) <= BWD_TOL[dtype], (name, _rel(gg, ww))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (2, 256, 4, 2, 64, True, 0), (1, 200, 4, 1, 128, True, 64), (2, 77, 2, 2, 32, False, 0),
    (4, 512, 12, 2, 128, True, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_fn_grads_match_plain_autograd(cuda, B, S, H, KV, hd, causal, window,
                                                       dtype):
    """``attention`` on CUDA tensors (FlashAttentionFn: forward kernel, then
    the backward kernel) against autograd of the plain version on the card.
    bf16 to 2.5e-2: the kernel's forward output, from which D is taken,
    differs from the plain one within the forward's own bound."""
    q, k, v, do = (t.transpose(1, 2).contiguous()
                   for t in _bwd_inputs(B, S, H, KV, hd, dtype, 9, cuda))
    fa = fa_ops.flash_attention
    before = (fa.launches, fa_ops.flash_attention_bwd.launches)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.attention(*ins, causal=causal, window=window)
    got = torch.autograd.grad(out, ins, do)
    torch.cuda.synchronize()
    assert (fa.launches, fa_ops.flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = attention_ref(*(t.transpose(1, 2) for t in ref_ins), causal=causal,
                            window=window).transpose(1, 2)
    want = torch.autograd.grad(ref_out, ref_ins, do)
    tol = 1e-5 if dtype == torch.float32 else 2.5e-2
    for name, gg, ww in zip("qkv", got, want):
        assert gg.dtype == dtype and gg.shape == ww.shape, name
        assert _rel(gg, ww) <= tol, (name, _rel(gg, ww))


def test_flash_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 64, 48, device=cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, q[:, :1], q[:, :1], q, q, lse)
    q = torch.zeros(1, 2, 64, 64, device=cuda)
    k = torch.zeros(1, 1, 32, 64, device=cuda)
    with pytest.raises(ValueError):          # Sq != Sk
        fa_ops.flash_attention_bwd(q, k, k, q, q, lse)
    with pytest.raises(TypeError):
        fa_ops.flash_attention_bwd(q, q[:, :1], q[:, :1], q.bfloat16(), q, lse)
    for bad in (None, lse[:, :1], lse.double(), lse.cpu()):   # no lse, or not the forward's
        with pytest.raises(ValueError):
            fa_ops.flash_attention_bwd(q, q[:, :1], q[:, :1], q, q, bad)


LSE_TOL = 1e-4


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_forward_lse_matches_plain(cuda, B, S, H, KV, hd, causal, window, dtype):
    """The lse each forward kernel stores (fa_fwd_sm90 for bf16 at 64 and
    128, fa_fwd_kernel otherwise) against attention_lse_ref; the output is
    the same as without lse, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q = torch.randn(B, H, S, hd, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, KV, S, hd, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, KV, S, hd, generator=g, device=cuda).to(dtype)
    out, lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    plain_out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    want = attention_lse_ref(q, k, v, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    err = float((lse - want).abs().max())
    assert err <= LSE_TOL, err


SM90_BWD_GROUPS = [(2, 2), (4, 2), (10, 2), (12, 2), (16, 2)]   # groups 1, 2, 5, 6, 8


@pytest.mark.parametrize("causal,window", SM90_MASKS)
@pytest.mark.parametrize("H,KV", SM90_BWD_GROUPS)
@pytest.mark.parametrize("S", [40, 384, 520])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_sm90_bwd_matches_plain(cuda, hd, S, H, KV, causal, window):
    """The tensor-core backward at ragged lengths, every cluster size of
    the configs and the masks, fed the forward kernel's output and lse."""
    q, k, v, do = _bwd_inputs(2, S, H, KV, hd, torch.bfloat16, S * 7 + H, cuda)
    o, lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    before = fa_ops.flash_attention_bwd.launches_sm90
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches_sm90 == before + 1
    want = attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    for name, gg, ww in zip("qkv", got, want):
        assert gg.dtype == torch.bfloat16 and gg.shape == ww.shape, name
        assert bool(torch.isfinite(gg.float()).all()), name
        assert _rel(gg, ww) <= BWD_TOL[torch.bfloat16], (name, _rel(gg, ww))


@pytest.mark.parametrize("B,S,H,KV,hd,window", [(4, 512, 12, 2, 128, 0),
                                                 (4, 512, 25, 5, 64, 2048),
                                                 (4, 512, 32, 4, 128, 0)])
def test_flash_sm90_bwd_two_calls_bit_identical(cuda, B, S, H, KV, hd, window):
    """No atomics: the G heads' dK and dV are summed in a fixed order."""
    q, k, v, do = _bwd_inputs(B, S, H, KV, hd, torch.bfloat16, 3, cuda)
    o, lse = fa_ops.flash_attention(q, k, v, causal=True, window=window, return_lse=True)
    first = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=window)
    second = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype,hd,H,kernel", [
    (torch.bfloat16, 64, 4, "sm90"), (torch.bfloat16, 128, 12, "sm90"),
    (torch.bfloat16, 64, 16, "sm90"), (torch.bfloat16, 64, 18, "simt"),
    (torch.float32, 64, 4, "simt"), (torch.float32, 128, 4, "simt"),
    (torch.bfloat16, 16, 4, "simt"), (torch.bfloat16, 32, 4, "simt"),
])
def test_flash_bwd_launch_goes_to_the_kernel_of_its_type(cuda, dtype, hd, H, kernel):
    """bf16 at head_dim 64 or 128 with at most 8 query heads per KV head
    (here KV 2) runs the tensor-core backward, everything else the
    CUDA-core one; each call counts once, on its route."""
    q = torch.randn(1, H, 128, hd, device=cuda).to(dtype)
    k = torch.randn(1, 2, 128, hd, device=cuda).to(dtype)
    o, lse = fa_ops.flash_attention(q, k, k, return_lse=True)
    fb = fa_ops.flash_attention_bwd
    before = (fb.launches, fb.launches_sm90, fb.launches_simt)
    fb(q, k, k, o, o, lse)
    torch.cuda.synchronize()
    sm90 = int(kernel == "sm90")
    assert (fb.launches, fb.launches_sm90, fb.launches_simt) == (
        before[0] + 1, before[1] + sm90, before[2] + 1 - sm90)


def _leaf_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu().float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def test_reduced_train_step_on_card_matches_cpu(cuda):
    """One float32 train step of the reduced qwen2-1.5b on the card (flash
    forward and backward kernels) and on the CPU (plain versions): loss and
    grad norm to 1e-5, the first moments (0.1 x the clipped gradient) to
    1e-4 of each leaf's largest, the new params to 1e-6 where the gradient
    is above 1e-3 of its leaf's largest."""
    cfg = reduced_config(get_config("qwen2-1.5b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = _train_batch(cfg)
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 64, 2), ce_chunk=32,
                                    compute_dtype=torch.float32), adamw.AdamWConfig())
    new_c, m_c = step(state, batch)
    fa = fa_ops.flash_attention
    before = (fa.launches, fa_ops.flash_attention_bwd.launches)
    new_g, m_g = step(_to(state, cuda), batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (fa.launches, fa_ops.flash_attention_bwd.launches) == (before[0] + 2 * L,
                                                                  before[1] + L)
    assert m_g["loss"] == pytest.approx(m_c["loss"], rel=1e-5)
    assert m_g["grad_norm"] == pytest.approx(m_c["grad_norm"], rel=1e-5)
    for name, t in flat_tensors(new_g["opt"]["m"]).items():
        assert _leaf_rel(t, flat_tensors(new_c["opt"]["m"])[name]) <= 1e-4, name
    # where the gradient is at rounding level, AdamW's first step is +-lr
    # by its sign, which the two devices may round either way
    for name, t in flat_tensors(new_g["params"]).items():
        m = flat_tensors(new_c["opt"]["m"])[name].abs()
        big = m > 1e-3 * m.max()
        diff = (t.cpu() - flat_tensors(new_c["params"])[name]).abs()
        assert float(diff[big].max()) <= 1e-6, name


def _train_batch(cfg):
    from repro_torch.data.pipeline import DataConfig, synth_batch
    return synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2), 0)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
def test_ssm_training_on_card_matches_cpu(cuda, arch):
    """One float32 train step of the reduced hybrid and ssm configs on the
    card (scan forward and backward kernels, flash kernels for hymba) and
    on the CPU (plain versions), held as the qwen2-1.5b step is."""
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = _train_batch(cfg)
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 64, 2), ce_chunk=32,
                                    compute_dtype=torch.float32), adamw.AdamWConfig())
    new_c, m_c = step(state, batch)
    sf, sb = scan_ops.selective_scan_fwd, scan_ops.selective_scan_bwd
    fa, fb = fa_ops.flash_attention, fa_ops.flash_attention_bwd
    before = (sf.launches, sb.launches, fa.launches, fb.launches)
    new_g, m_g = step(_to(state, cuda), batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    attn = L if cfg.has_attention else 0
    assert (sf.launches, sb.launches, fa.launches, fb.launches) == (
        before[0] + 2 * L, before[1] + L, before[2] + 2 * attn, before[3] + attn)
    assert m_g["loss"] == pytest.approx(m_c["loss"], rel=1e-5)
    assert m_g["grad_norm"] == pytest.approx(m_c["grad_norm"], rel=1e-5)
    for name, t in flat_tensors(new_g["opt"]["m"]).items():
        assert _leaf_rel(t, flat_tensors(new_c["opt"]["m"])[name]) <= 1e-4, name
    for name, t in flat_tensors(new_g["params"]).items():
        m = flat_tensors(new_c["opt"]["m"])[name].abs()
        big = m > 1e-3 * m.max()
        diff = (t.cpu() - flat_tensors(new_c["params"])[name]).abs()
        assert float(diff[big].max()) <= 1e-6, name


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_moe_training_on_card_matches_cpu(cuda, arch):
    """One float32 train step of the reduced MoE configs on the card (flash
    forward and backward kernels, routing and dispatch in plain PyTorch)
    and on the CPU, held as the qwen2-1.5b step is; the aux term too."""
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = _train_batch(cfg)
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 64, 2), ce_chunk=32,
                                    compute_dtype=torch.float32), adamw.AdamWConfig())
    new_c, m_c = step(state, batch)
    fa, fb = fa_ops.flash_attention, fa_ops.flash_attention_bwd
    before = (fa.launches, fb.launches)
    new_g, m_g = step(_to(state, cuda), batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (fa.launches, fb.launches) == (before[0] + 2 * L, before[1] + L)
    for key in ("loss", "aux_loss", "grad_norm"):
        assert m_g[key] == pytest.approx(m_c[key], rel=1e-5), key
    for name, t in flat_tensors(new_g["opt"]["m"]).items():
        assert _leaf_rel(t, flat_tensors(new_c["opt"]["m"])[name]) <= 1e-4, name
    for name, t in flat_tensors(new_g["params"]).items():
        m = flat_tensors(new_c["opt"]["m"])[name].abs()
        big = m > 1e-3 * m.max()
        diff = (t.cpu() - flat_tensors(new_c["params"])[name]).abs()
        assert float(diff[big].max()) <= 1e-6, name


@pytest.mark.parametrize("arch,policy", [("internvl2-76b", None), ("internvl2-76b", "dots"),
                                         ("musicgen-large", None), ("qwen2-1.5b", "dots")])
def test_vlm_audio_and_dots_training_on_card_matches_cpu(cuda, arch, policy):
    """One float32 train step of the reduced internvl2-76b (pixel embeds
    before the text, loss over the text) and musicgen-large on the card and
    on the CPU, also with ``remat_policy="dots"``, held as the qwen2-1.5b
    step is; "dots" launches the flash kernels as the default remat does
    (the recompute runs the attention again)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train_batch
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    batch = train_batch(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2), 0)
    step = make_train_step(CellPlan(cfg, ShapeCell("t", "train", 64, 2), ce_chunk=32,
                                    compute_dtype=torch.float32, remat_policy=policy),
                           adamw.AdamWConfig())
    new_c, m_c = step(state, batch)
    fa, fb = fa_ops.flash_attention, fa_ops.flash_attention_bwd
    before = (fa.launches, fb.launches)
    new_g, m_g = step(_to(state, cuda), batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (fa.launches, fb.launches) == (before[0] + 2 * L, before[1] + L)
    for key in ("loss", "grad_norm"):
        assert m_g[key] == pytest.approx(m_c[key], rel=1e-5), key
    for name, t in flat_tensors(new_g["opt"]["m"]).items():
        assert _leaf_rel(t, flat_tensors(new_c["opt"]["m"])[name]) <= 1e-4, name
    for name, t in flat_tensors(new_g["params"]).items():
        m = flat_tensors(new_c["opt"]["m"])[name].abs()
        big = m > 1e-3 * m.max()
        diff = (t.cpu() - flat_tensors(new_c["params"])[name]).abs()
        assert float(diff[big].max()) <= 1e-6, name


@pytest.mark.parametrize("kv_dtype", [None, torch.int8], ids=["float32", "int8"])
def test_vlm_serve_slice_on_card_matches_cpu(cuda, kv_dtype):
    """The reduced internvl2-76b serving slice in float32 on the card, with
    a float32 and an int8 cache, against ``generate`` on the CPU with the
    same params, prompts and pixel embeds: the same greedy tokens, prefill
    logits within 1e-4 of the largest."""
    cfg = reduced_config(get_config("internvl2-76b"))
    run = serve.run(cfg, device=cuda, batch=2, prompt_len=64, tokens=4, seed=0,
                    compute_dtype=torch.float32, kv_dtype=kv_dtype)
    prompts = run.prompts.cpu()
    pixels = serve.request_pixel_embeds(cfg, 2, 0, "cpu")
    for params, (logits, toks) in ((run.params_v0, run.out_v0), (run.params_v1, run.out_v1)):
        lc, tc = serve.generate(cfg, _to(params, "cpu"), prompts, 4, pixel_embeds=pixels,
                                compute_dtype=torch.float32, kv_dtype=kv_dtype)
        np.testing.assert_allclose(logits.cpu().numpy(), lc.numpy(), rtol=0,
                                   atol=1e-4 * float(lc.abs().max()))
        assert torch.equal(toks.cpu(), tc)


def test_quantize_kv_on_card_equals_cpu(cuda):
    """``quantize_kv`` gives the same int8 values and scales, bit for bit,
    on the card as on the CPU (IEEE division on both; a Python-number
    divisor on CUDA would be a product with its reciprocal, one ulp off for
    some 4% of values), on float32 and bf16 K/V rows of hd 64 and 128."""
    g = torch.Generator().manual_seed(3)
    for hd, dtype in ((64, torch.float32), (128, torch.float32), (128, torch.bfloat16)):
        t = (torch.randn(4096, 8, hd, generator=g) * torch.rand(4096, 8, 1, generator=g)
             * 10).to(dtype)
        q, scale = M.quantize_kv(t)
        qg, sg = M.quantize_kv(t.to(cuda))
        assert torch.equal(qg.cpu(), q) and torch.equal(sg.cpu(), scale), (hd, dtype)


def test_int8_decode_on_card_matches_cpu(cuda, monkeypatch):
    """Decode with an int8 cache, card against CPU, the reduced
    internvl2-76b in float32. A value whose quotient t / scale lies within
    float32 rounding of a half step may round the other way on the two
    devices (t differs in the last bits), and later steps carry that on,
    so the quantization and the arithmetic are held apart, as in
    chip_smoke.py: the card's quantization of its K/V equals the CPU's of
    the same values bit for bit, and the card's logits lie within 2e-2 of
    the largest of the CPU's decode given the card's quantized values (the
    attention over the dequantized cache runs in bf16, as the reference's;
    the bf16 bound of the CPU parity tests)."""
    cfg = reduced_config(get_config("internvl2-76b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    quantize = M.quantize_kv

    def decode(device, replay=None):
        calls = []

        def recorded(t):
            q, scale = quantize(t) if replay is None else (x.to(t.device)
                                                           for x in replay[len(calls)])
            calls.append((t.cpu(), q.cpu(), scale.cpu()))
            return q, scale

        monkeypatch.setattr(M, "quantize_kv", recorded)
        cache = M.make_decode_cache(cfg, 2, 12, torch.int8, device=device)
        ps = _to(params, device)
        out = [M.decode_step(cfg, ps, cache, toks[:, i:i + 1].to(device), i,
                             compute_dtype=torch.float32)[0].cpu() for i in range(12)]
        return torch.stack(out), calls

    lg, calls_g = decode(cuda)
    lr, _ = decode("cpu", replay=[(q, s) for _, q, s in calls_g])
    assert len(calls_g) == 2 * 12 * cfg.num_layers
    for tg, qg, sg in calls_g:
        q, scale = quantize(tg)
        assert torch.equal(q, qg) and torch.equal(scale, sg)
    assert float((lg - lr).abs().max()) <= 2e-2 * float(lr.abs().max())


def test_moe_serve_slice_on_card_matches_cpu(cuda):
    """The reduced qwen3-moe-30b-a3b serving slice in float32 on the card
    against ``generate`` on the CPU with the same params and prompts: the
    same greedy tokens and prefill logits within 1e-4 of the largest, for
    v0 and v1; the delta publish finds the expert block, and the served
    params are bit-identical to the published ones."""
    cfg = reduced_config(get_config("qwen3-moe-30b-a3b"))
    run = serve.run(cfg, device=cuda, batch=2, prompt_len=64, tokens=4, seed=0,
                    compute_dtype=torch.float32)
    prompts = run.prompts.cpu()
    for params, (logits, toks) in ((run.params_v0, run.out_v0), (run.params_v1, run.out_v1)):
        lc, tc = serve.generate(cfg, _to(params, "cpu"), prompts, 4,
                                compute_dtype=torch.float32)
        np.testing.assert_allclose(logits.cpu().numpy(), lc.numpy(), rtol=0,
                                   atol=1e-4 * float(lc.abs().max()))
        assert torch.equal(toks.cpu(), tc)
    dirty = run.publish_v1.dirty
    assert dirty["params/layers/moe/wi"]
    assert run.publish_v1.stats["blocks_written"] == sum(len(v) for v in dirty.values())
    served = flat_tensors({"params": run.slice.device_params()})
    want = flat_tensors({"params": run.params_v1})
    for name, t in served.items():
        assert torch.equal(t.view(torch.int32), want[name].view(torch.int32)), name


def test_plain_scan_train_step_on_card_launches_no_scan_kernel(cuda):
    cfg = reduced_config(get_config("hymba-1.5b"))
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda)
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    plan = CellPlan(cfg, ShapeCell("t", "train", 64, 2), ce_chunk=32,
                    compute_dtype=torch.float32, attn_impl="plain", scan_impl="plain")
    counters = (scan_ops.selective_scan_fwd, scan_ops.selective_scan_bwd,
                fa_ops.flash_attention, fa_ops.flash_attention_bwd)
    before = [c.launches for c in counters]
    _, metrics = make_train_step(plan, adamw.AdamWConfig())(state, _train_batch(cfg))
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["grad_norm"])


@pytest.mark.parametrize("nb,be", [(4, 128), (8, 256), (16, 512), (1, 1024), (3, 65536),
                                   (5, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block_delta_kernel_matches_plain(cuda, nb, be, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    new = torch.randn(nb, be, generator=g, device=cuda).to(dtype)
    old = (new.float() + 0.01 * torch.randn(nb, be, generator=g, device=cuda)).to(dtype)
    old[0] = new[0]                                       # one clean block
    qk, nk, sk = bd_ops.compute_block_delta(new, old)
    torch.cuda.synchronize()
    qr, nr, sr = block_delta_ref(new, old)
    assert torch.equal(qk, qr)
    assert torch.equal(sk, sr)
    np.testing.assert_allclose(nk.cpu().numpy(), nr.cpu().numpy(), rtol=1e-5)
    assert float(nk[0]) == 0.0


def test_dirty_block_indices_on_card_equals_exact_compare(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    old = torch.randn(3 * 65536 + 77, generator=g, device=cuda)
    new = old.clone()
    new[5] += 1.0
    new[2 * 65536 + 3] -= 0.5
    new[-1] += 2.0
    before = bd_ops.block_delta.launches
    got = dirty_block_indices(new, old, 1 << 18)
    assert bd_ops.block_delta.launches == before + 1
    assert got == exact_dirty_blocks(new, old, 1 << 18) == [0, 2, 3]


def _delta_pair(n, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    new = torch.randn(n, generator=g, device=device)
    old = (new + 0.1 * torch.randn(n, generator=g, device=device)).to(dtype)
    return new.to(dtype), old


def _special_rows(be, dtype, device):
    """Rows of ``be`` in a flat leaf: ordinary, NaN, +inf, -inf, inf - inf,
    a zero-sign flip, a scale that flushes to 0 (deltas near 1e-38), all
    deltas subnormal (flushed), NaN payload only, clean."""
    g = torch.Generator(device=device).manual_seed(11)
    nrow = 10
    old = torch.randn(nrow, be, generator=g, device=device)
    new = old + 0.01 * torch.randn(nrow, be, generator=g, device=device)
    new[1, 17] = float("nan")
    new[2, 5] = float("inf")
    new[3, 9] = -float("inf")
    old[4, 0], new[4, 0] = float("inf"), float("inf")
    new[4, 1] = -float("inf")
    old[5] = 0.0
    new[5] = 0.0
    new[5, 3] = -0.0
    old[6] = 0.0
    new[6] = torch.randn(be, generator=g, device=device) * 1e-38
    old[7] = 0.0
    new[7] = torch.randn(be, generator=g, device=device) * 1e-39   # subnormal in bf16 too
    old[8] = 0.0
    old[8, 2] = float("nan")
    new[8] = old[8]
    old[9] = new[9]
    new, old = new.to(dtype), old.to(dtype)
    if dtype == torch.float32:
        new.view(torch.int32)[8, 2] += 3
    else:
        new.view(torch.int16)[8, 2] += 3
    return new.reshape(-1), old.reshape(-1)


def _assert_flat_equal(got, want):
    qk, nk, sk, dk = got
    qr, nr, sr, dr = want
    assert torch.equal(qk, qr)
    assert torch.equal(sk, sr) or bool(((sk == sr) | (sk.isnan() & sr.isnan())).all())
    assert torch.equal(dk, dr)
    np.testing.assert_allclose(nk.cpu().numpy(), nr.cpu().numpy(), rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("n,be,dtype", [
    (3 * 65536, 65536, torch.float32),
    (3 * 65536 + 77, 65536, torch.float32),       # ragged, not a whole 16-byte load
    (2 * 65536 + 4, 65536, torch.float32),
    (5 * 32768 + 1000, 32768, torch.float32),
    (2 * 131072 + 8, 131072, torch.bfloat16),
    (4 * 131072 + 3, 131072, torch.bfloat16),
    (7 * 4096 + 96, 4096, torch.bfloat16),
])
def test_block_delta_cluster_kernel_matches_plain(cuda, n, be, dtype):
    new, old = _delta_pair(n, dtype, 2, cuda)
    old[:be] = new[:be]                                  # one clean row
    before = (bd_ops.block_delta.launches_cluster, bd_ops.block_delta.launches_two_pass)
    got = bd_ops.block_delta_flat(new, old, be)
    torch.cuda.synchronize()
    assert (bd_ops.block_delta.launches_cluster, bd_ops.block_delta.launches_two_pass) == \
        (before[0] + 1, before[1])
    want = block_delta_flat_ref(new, old, be)
    _assert_flat_equal(got, want)
    assert not bool(got[3][0]) and bool(got[3][1:-1].all())


@pytest.mark.parametrize("be,dtype", [(65536, torch.float32), (32768, torch.float32),
                                      (131072, torch.bfloat16)])
@pytest.mark.parametrize("kernel", ["cluster", "two_pass"])
def test_block_delta_special_rows_match_plain(cuda, be, dtype, kernel):
    new, old = _special_rows(be, dtype, cuda)
    got = bd_ops.block_delta_flat(new, old, be, kernel=kernel)
    torch.cuda.synchronize()
    want = block_delta_flat_ref(new, old, be)
    _assert_flat_equal(got, want)
    assert got[3].tolist() == [True] * 9 + [False]
    assert float(got[2][6]) == 0.0 and float(got[2][7]) == 1.0 and float(got[2][1]) == 1.0


@pytest.mark.parametrize("be,threads", [(65536, 256), (131072, 512), (262144, 1024)],
                         ids=["256", "512", "1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block_delta_cluster_kernel_every_block_size(cuda, be, threads, dtype):
    """Every block size the source builds, reached through the route by row
    length: rows of 65,536, 131,072 and 262,144 elements, each a cluster of
    16 blocks."""
    assert bd_ops.cluster_shape(be, dtype) == (threads, 16)
    new, old = _delta_pair(6 * be + 40, dtype, 3, cuda)
    old[2 * be:3 * be] = new[2 * be:3 * be]
    before = (bd_ops.block_delta.launches_cluster, bd_ops.block_delta.launches_two_pass)
    got = bd_ops.block_delta_flat(new, old, be)
    torch.cuda.synchronize()
    assert (bd_ops.block_delta.launches_cluster, bd_ops.block_delta.launches_two_pass) == \
        (before[0] + 1, before[1])
    _assert_flat_equal(got, block_delta_flat_ref(new, old, be))
    assert got[3].tolist() == [True, True, False, True, True, True, True]


@pytest.mark.parametrize("case", ["long_rows", "odd_length", "misaligned"])
def test_block_delta_two_pass_kernel_takes_what_the_cluster_kernel_does_not(cuda, case):
    be = {"long_rows": 1 << 19, "odd_length": 1002, "misaligned": 65536}[case]
    new, old = _delta_pair(3 * be + 5 + 1, torch.float32, 4, cuda)
    if case == "misaligned":                             # 4 bytes past a 16-byte boundary
        new, old = new[1:], old[1:]
    before = (bd_ops.block_delta.launches_cluster, bd_ops.block_delta.launches_two_pass)
    got = bd_ops.block_delta_flat(new, old, be)
    torch.cuda.synchronize()
    assert (bd_ops.block_delta.launches_cluster, bd_ops.block_delta.launches_two_pass) == \
        (before[0], before[1] + 1)
    _assert_flat_equal(got, block_delta_flat_ref(new, old, be))
    with pytest.raises(ValueError):
        bd_ops.block_delta_flat(new, old, be, kernel="cluster")


def test_dirty_block_indices_on_card_sees_special_changes(cuda):
    new, old = _special_rows(65536, torch.float32, cuda)
    before = bd_ops.block_delta.launches_cluster
    got = dirty_block_indices(new, old, 1 << 18)
    assert bd_ops.block_delta.launches_cluster == before + 1
    assert got == exact_dirty_blocks(new, old, 1 << 18) == list(range(9))


def test_dirty_block_indices_on_card_sees_underflowing_delta(cuda):
    old = torch.zeros(3 * 65536, device=cuda)
    new = old.clone()
    new[65536 + 9] = 1e-25                  # its square underflows float32
    assert dirty_block_indices(new, old, 1 << 18) == [1]


def _scan_inputs(B, S, Di, N, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, S, Di, generator=g, device=device)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, Di, generator=g, device=device) * 0.5 - 1.0)
    b = torch.randn(B, S, N, generator=g, device=device)
    c = torch.randn(B, S, N, generator=g, device=device)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device)).repeat(Di, 1)
    d = torch.full((Di,), 0.5, device=device)
    return x, dt, b, c, a_log, d


@pytest.mark.parametrize("B,S,Di,N", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssm_scan_kernel_matches_plain(cuda, B, S, Di, N, dtype):
    x, dt, b, c, a_log, d = _scan_inputs(B, S, Di, N, cuda)
    x = x.to(dtype)
    a = -torch.exp(a_log)
    before = scan_ops.selective_scan_fwd.launches
    y, h = scan_ops.selective_scan(x, dt, b, c, a, d)
    torch.cuda.synchronize()
    assert scan_ops.selective_scan_fwd.launches == before + 1
    yr, hr = selective_scan_ref(x, dt, b, c, a, d)
    assert y.dtype == dtype and y.shape == x.shape and h.shape == (B, Di, N)
    assert float((y.float() - yr.float()).abs().max()) < SCAN_TOL[dtype]
    assert float((h - hr).abs().max()) < 2e-4
    # the Pallas signature
    yp = scan_ops.ssm_scan(x, dt, b, c, a_log, d)
    assert float((yp.float() - yr.float()).abs().max()) < SCAN_TOL[dtype]


def test_ssm_scan_kernel_continues_from_h0(cuda):
    """Two launches over halves of the sequence, the second from the first's
    last state, give the one-launch result."""
    x, dt, b, c, a_log, d = _scan_inputs(2, 64, 48, 16, cuda, seed=4)
    a = -torch.exp(a_log)
    y, h = scan_ops.selective_scan(x, dt, b, c, a, d)
    y1, h1 = scan_ops.selective_scan(x[:, :40], dt[:, :40], b[:, :40], c[:, :40], a, d)
    y2, h2 = scan_ops.selective_scan(x[:, 40:], dt[:, 40:], b[:, 40:], c[:, 40:], a, d, h0=h1)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(h2, h)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("Di", [48, 3216])
@pytest.mark.parametrize("S", [1, 63, 65, 520])
def test_ssm_scan_staged_chunks_match_plain(cuda, S, Di, N, with_h0):
    """Sequence lengths around the 64-step chunk and channel counts around
    the 64-channel block, from a zero or a given state, x bf16 as served."""
    x, dt, b, c, a_log, d = _scan_inputs(2, S, Di, N, cuda, seed=S + Di)
    x = x.bfloat16()
    a = -torch.exp(a_log)
    h0 = 0.5 * torch.randn(2, Di, N, device=cuda) if with_h0 else None
    y, h = scan_ops.selective_scan(x, dt, b, c, a, d, h0=h0)
    torch.cuda.synchronize()
    yr, hr = selective_scan_ref(x, dt, b, c, a, d, h0=h0)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and h.shape == (2, Di, N)
    assert _bf16_y_close(y, yr)
    assert float((h - hr).abs().max()) < 2e-4


@pytest.mark.parametrize("kernel", ["flash_qwen2", "flash_hymba", "flash_qwen3_moe",
                                    "flash_internvl2", "flash_musicgen", "scan_hymba"])
def test_chip_smoke_serving_shapes_match_plain(cuda, kernel):
    """The serving-shape cases of chip_smoke.py with its inputs and bounds:
    flash at qwen2-1.5b (B 4, S 512, H 12, KV 2, hd 128), hymba-1.5b (H 25,
    KV 5, hd 64, window 2048) and qwen3-moe-30b-a3b (H 32, KV 4, hd 128),
    bf16, causal; the scan at hymba-1.5b (B 4, S 512, Di 3200, N 16) with x
    bf16 and A from bf16-rounded A_log."""
    if kernel.startswith("flash"):
        B, S, H, KV, hd, window = {"flash_qwen2": (4, 512, 12, 2, 128, 0),
                                   "flash_hymba": (4, 512, 25, 5, 64, 2048),
                                   "flash_qwen3_moe": (4, 512, 32, 4, 128, 0),
                                   "flash_internvl2": (4, 768, 64, 8, 128, 0),
                                   "flash_musicgen": (4, 512, 32, 32, 64, 0)}[kernel]
        g = torch.Generator(device=cuda).manual_seed(7)
        q, k, v = (torch.randn(B, n, S, hd, generator=g, device=cuda).bfloat16()
                   for n in (H, KV, KV))
        got = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        want = attention_ref(q, k, v, causal=True, window=window)
        assert float((got.float() - want.float()).abs().max()) < TOL[torch.bfloat16]
        return
    x, dt, b, c, a_log, d = _scan_inputs(4, 512, 3200, 16, cuda, seed=9)
    a = -torch.exp(a_log.bfloat16().float())
    x = x.bfloat16()
    y, h = scan_ops.selective_scan(x, dt, b, c, a, d)
    yr, hr = selective_scan_ref(x, dt, b, c, a, d)
    assert _bf16_y_close(y, yr)
    assert float((h - hr).abs().max()) < 2e-4


def _bf16_y_close(y, yr) -> bool:
    """bf16 y within 1e-1 of the plain version, or one bf16 ulp of a larger
    value (chip_smoke.py's serving-shape check)."""
    diff = (y.float() - yr.float()).abs()
    return float(diff.max()) < SCAN_TOL[torch.bfloat16] or \
        float((diff - yr.float().abs() * 2.0 ** -7).max()) <= 0


def test_ssm_scan_kernel_refuses_unsupported_state_size(cuda):
    x, dt, b, c, a_log, d = _scan_inputs(1, 8, 16, 12, cuda)
    with pytest.raises(ValueError):
        scan_ops.selective_scan_fwd(x, dt, b, c, -torch.exp(a_log), d)


# Scan backward, kernel against selective_scan_bwd_ref, max |diff| over the
# gradient's largest |value|: float32 sums in another order; dx rounds to
# bf16 when x is bf16.
SCAN_BWD_TOL = {"float32": 1e-4, "dx_bf16": 2e-2}
SCAN_GRADS = ("dx", "ddt", "db", "dc", "da", "dd", "dh0")


def _scan_bwd_inputs(B, S, Di, N, dtype, with_state, device, seed=5):
    x, dt, b, c, a_log, d = _scan_inputs(B, S, Di, N, device, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    a = -torch.exp(a_log) * torch.exp(0.1 * torch.randn(Di, N, generator=g, device=device))
    d = torch.randn(Di, generator=g, device=device)
    dy = torch.randn(B, S, Di, generator=g, device=device).to(dtype)
    h0 = 0.5 * torch.randn(B, Di, N, generator=g, device=device) if with_state else None
    dh = torch.randn(B, Di, N, generator=g, device=device) if with_state else None
    return x.to(dtype), dt, b, c, a, d, h0, dy, dh


def _scan_bwd_errors(got, want, with_h0):
    """{gradient: max |diff| / its largest |value|}, dh0 only with h0."""
    out = {}
    for name, gg, ww in zip(SCAN_GRADS, got, want):
        if name == "dh0" and not with_h0:
            continue
        assert gg.dtype == ww.dtype and gg.shape == ww.shape, name
        assert bool(torch.isfinite(gg.float()).all()), name
        out[name] = float((gg.float() - ww.float()).abs().max()
                          / ww.float().abs().max().clamp_min(1e-30))
    return out


def _scan_bwd_within(errs, dtype) -> bool:
    return all(e <= (SCAN_BWD_TOL["dx_bf16"] if n == "dx" and dtype == torch.bfloat16
                     else SCAN_BWD_TOL["float32"]) for n, e in errs.items())


@pytest.mark.parametrize("with_state", [False, True], ids=["no_h0", "h0_dh_last"])
@pytest.mark.parametrize("B,S,Di,N", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssm_scan_bwd_kernel_matches_plain(cuda, B, S, Di, N, dtype, with_state):
    x, dt, b, c, a, d, h0, dy, dh = _scan_bwd_inputs(B, S, Di, N, dtype, with_state, cuda)
    y, h_last, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, h0=h0, chunk_states=True)
    before = scan_ops.selective_scan_bwd.launches
    got = scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh)
    torch.cuda.synchronize()
    assert scan_ops.selective_scan_bwd.launches == before + 1
    want = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, h0=h0, dh_last=dh)
    errs = _scan_bwd_errors(got, want, with_state)
    assert _scan_bwd_within(errs, dtype), errs


@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("Di", [32, 48, 96, 136, 3216])
@pytest.mark.parametrize("S", [1, 63, 65, 520])
def test_ssm_scan_bwd_staged_chunks_match_plain(cuda, S, Di, N):
    """Sequence lengths around the 64-step chunk and its 8-step sub-chunks;
    channel counts around the 32-channel block and its cluster of 4 blocks
    (at N 8 and 16): one block, a block and a half, one block less than a
    cluster, a cluster and a block, and 101 blocks, whose last cluster has
    one block with channels and three without; x bf16 as trained."""
    x, dt, b, c, a, d, h0, dy, dh = _scan_bwd_inputs(2, S, Di, N, torch.bfloat16, True, cuda,
                                                     seed=S + Di)
    _, _, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, h0=h0, chunk_states=True)
    got = scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh)
    want = selective_scan_bwd_ref(x, dt, b, c, a, d, dy, h0=h0, dh_last=dh)
    errs = _scan_bwd_errors(got, want, True)
    assert _scan_bwd_within(errs, torch.bfloat16), errs


def test_ssm_scan_bwd_training_shape_fits_one_wave(cuda):
    """At hymba-1.5b's training shape the whole grid is resident at once,
    at 16 warps or more an SM, without spills."""
    geo = scan_ops.selective_scan_bwd_geometry(4, 512, 3200, 16)
    assert geo["waves"] <= 1.0 and geo["blocks"] <= geo["blocks_per_sm"] * geo["sms"], geo
    assert geo["warps_per_sm"] >= 16 and geo["local_bytes"] == 0, geo


@pytest.mark.parametrize("B,S,Di,N", [(4, 512, 3200, 16), (3, 33, 100, 16), (1, 17, 5, 32)])
def test_ssm_scan_bwd_two_calls_bit_identical(cuda, B, S, Di, N):
    x, dt, b, c, a, d, h0, dy, dh = _scan_bwd_inputs(B, S, Di, N, torch.bfloat16, True, cuda)
    _, _, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, h0=h0, chunk_states=True)
    first = scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh)
    again = scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc, dh_last=dh)
    torch.cuda.synchronize()
    for name, u, v in zip(SCAN_GRADS, first, again):
        assert torch.equal(u.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), name


@pytest.mark.parametrize("B,S,Di,N", [(2, 130, 48, 16), (1, 64, 100, 8), (4, 512, 3200, 16)])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
def test_ssm_scan_forward_chunk_states_match_plain(cuda, B, S, Di, N, with_h0):
    """The states the forward saves for the backward, against the plain
    version's; saving them leaves y and the last state as they were."""
    x, dt, b, c, a, d, h0, _, _ = _scan_bwd_inputs(B, S, Di, N, torch.bfloat16, with_h0, cuda)
    y0, h_0 = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, h0=h0)
    y, h_last, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, h0=h0, chunk_states=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y0) and torch.equal(h_last, h_0)
    _, _, hr = selective_scan_ref(x, dt, b, c, a, d, h0=h0, return_chunk_states=True)
    assert hc.shape == hr.shape == (B, -(-S // 64), Di, N)
    assert float((hc - hr).abs().max()) < 2e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_selective_scan_fn_on_card_matches_plain_autograd(cuda, dtype):
    """Autograd through the model's scan on the card (one forward launch
    with chunk states, one backward launch) against autograd of the plain
    recurrence on the card."""
    x, dt, b, c, a, d, h0, dy, dh = _scan_bwd_inputs(2, 130, 96, 16, dtype, True, cuda)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, dt, b, c, a, d, h0)]
    sf, sb = scan_ops.selective_scan_fwd, scan_ops.selective_scan_bwd
    before = (sf.launches, sb.launches)
    y, h_last = ssm_model.selective_scan(*ins[:6], h0=ins[6])
    got = torch.autograd.grad([y, h_last], ins, [dy, dh])
    torch.cuda.synchronize()
    assert (sf.launches, sb.launches) == (before[0] + 1, before[1] + 1)
    ref_ins = [t.detach().clone().requires_grad_(True) for t in (x, dt, b, c, a, d, h0)]
    yr, hr = ssm_model.selective_scan(*ref_ins[:6], h0=ref_ins[6], impl="plain")
    assert (sf.launches, sb.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad([yr, hr], ref_ins, [dy, dh])
    errs = _scan_bwd_errors(got, want, True)
    assert _scan_bwd_within(errs, dtype), errs


def test_ssm_scan_bwd_refuses_what_it_does_not_take(cuda):
    x, dt, b, c, a, d, h0, dy, dh = _scan_bwd_inputs(1, 8, 16, 8, torch.float32, True, cuda)
    _, _, hc = scan_ops.selective_scan_fwd(x, dt, b, c, a, d, chunk_states=True)
    with pytest.raises(ValueError):      # tensors on the CPU
        scan_ops.selective_scan_bwd(*(t.cpu() for t in (x, dt, b, c, a, d, dy)),
                                    chunk_states=hc.cpu())
    with pytest.raises(ValueError):      # chunk states of another length
        scan_ops.selective_scan_bwd(x, dt, b, c, a, d, dy, chunk_states=hc[:, :0])
    x12, dt12, b12, c12, a12, d12, _, dy12, _ = _scan_bwd_inputs(1, 8, 16, 12, torch.float32,
                                                                 False, cuda)
    hc12 = torch.zeros(1, 1, 16, 12, device=cuda)
    with pytest.raises(ValueError):      # N = 12 is not a state size of the kernels
        scan_ops.selective_scan_bwd(x12, dt12, b12, c12, a12, d12, dy12, chunk_states=hc12)
    with pytest.raises(TypeError):       # float16 x
        scan_ops.selective_scan_bwd(x.half(), dt, b, c, a, d, dy.half(), chunk_states=hc)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_reduced_generate_on_card_matches_cpu(cuda, arch):
    """The reduced serving computation in float32: card (kernels) and CPU
    (plain versions) give the same greedy tokens and close logits."""
    cfg = reduced_config(get_config(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 40)))
    lc, tc = serve.generate(cfg, params, prompts, 8, compute_dtype=torch.float32)
    dev = _to(params, cuda)
    before = (fa_ops.flash_attention.launches, scan_ops.selective_scan_fwd.launches)
    lg, tg = serve.generate(cfg, dev, prompts.to(cuda), 8, compute_dtype=torch.float32)
    L = cfg.num_layers
    assert fa_ops.flash_attention.launches == before[0] + (L if cfg.has_attention else 0)
    assert scan_ops.selective_scan_fwd.launches == before[1] + (L if cfg.has_ssm else 0)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                               atol=1e-4 * float(lc.abs().max()))
    assert torch.equal(tg.cpu(), tc)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_serve_slice_on_card_publishes_and_serves_exact_bytes(cuda):
    cfg = reduced_config(get_config("qwen2-1.5b"))
    run = serve.run(cfg, device=cuda, batch=2, prompt_len=64, tokens=4,
                    compute_dtype=torch.float32)
    dirty = run.publish_v1.dirty
    assert run.publish_v1.stats["blocks_written"] == sum(len(v) for v in dirty.values()) > 0
    served = run.slice.device_params()
    want = flat_tensors(run.params_v1)
    for name, t in flat_tensors(served).items():
        assert torch.equal(t.view(torch.int32), want[name].view(torch.int32)), name
