"""The port's CUDA kernels and its serving slice on the card.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time). On a machine with the card:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

builds the kernels (``nvcc``, ``sm_90a``) and holds each against its plain
version on the same inputs: flash attention to 1e-5 in float32 and 2.5e-2
in bf16 (the reference tests' bounds), block delta with q equal as int8,
scale equal and norm2 to rtol 1e-5 (sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.bridge import flat_tensors
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels.block_delta import ops as bd_ops
from repro_torch.kernels.block_delta.ref import block_delta_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import serve
from repro_torch.models import model as M
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
]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.5e-2}


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


def test_flash_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros(1, 2, 64, 48, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q[:, :1], q[:, :1])


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


def test_dirty_block_indices_on_card_sees_underflowing_delta(cuda):
    old = torch.zeros(3 * 65536, device=cuda)
    new = old.clone()
    new[65536 + 9] = 1e-25                  # its square underflows float32
    assert dirty_block_indices(new, old, 1 << 18) == [1]


def test_reduced_generate_on_card_matches_cpu(cuda):
    """The reduced serving computation in float32: card (flash kernel) and
    CPU (plain math) give the same greedy tokens and close logits."""
    cfg = reduced_config(get_config("qwen2-1.5b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 40)))
    lc, tc = serve.generate(cfg, params, prompts, 8, compute_dtype=torch.float32)
    dev = _to(params, cuda)
    before = fa_ops.flash_attention.launches
    lg, tg = serve.generate(cfg, dev, prompts.to(cuda), 8, compute_dtype=torch.float32)
    assert fa_ops.flash_attention.launches == before + cfg.num_layers
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
