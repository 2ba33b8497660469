"""GQA flash-attention forward.

Port of ``repro/kernels/flash_attention.py:flash_attention_fwd`` (kernel
body ``_flash_fwd_kernel``).  q: [b, h, sq, d]; k, v: [b, hk, sk, d] with
h % hk == 0; f32 or bf16 (computed in f32, returned in q's dtype).  Causal
masking is bottom-right aligned (query i sees keys ``j <= i + (sk - sq)``),
masked logits are -1e30 and a row with no visible key writes zeros.

  * ``flash_attention_torch`` — the plain PyTorch version: the online-
    softmax math of ``attention_plain.chunked_attention``;
  * the CUDA kernel ``csrc/flash_attention.cu`` on the tensor cores
    (``wgmma``: bf16 Q K^T in one bf16 product and P V in two, P split
    into bf16 hi and lo halves as the reference keeps p in f32; f32
    products as three TF32 products, 3xTF32), within 2e-4 (f32) and 3e-2
    (bf16) of the plain version.

``flash_attention_fwd`` dispatches on the tensors' device: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.  On the
card it refuses what the kernel does not take: head widths above 256,
mixed dtypes and causal ``sq > sk`` — rows that see no key there get a
value that depends on the TPU kernel's block size, and no model path asks
for it (the LM's attention always has ``sq == sk``).
``flash_attention_fwd.launches`` counts kernel launches.  On the meta
device (the dry run) it returns an empty output and computes nothing;
under a ``roofline.counts.OpCounts`` each forward counts ``flash_work``.

Both devices go through one ``torch.autograd.Function``, the port of the
reference's ``custom_vjp`` (``repro/kernels/ops.py:_pallas_attention``):
its forward is the kernel (or, on the CPU, the plain version) on detached
inputs, saving q, k and v; its backward recomputes the attention through
``chunked_attention`` under autograd and returns that VJP, as
``_pallas_attention_bwd`` does.  There is no backward kernel, here or in
the reference.  Inputs that require grad on the card launch the forward
kernel like any others; a non-reentrant activation checkpoint that
recomputes the forward launches it again.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.attention_plain import chunked_attention
from repro_torch.roofline.counts import flash_work, kernel_call

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """Plain version: the chunked online softmax of the reference's XLA
    path (``chunked_attention``)."""
    return chunked_attention(q, k, v, causal=causal, scale=scale)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (once)."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_launch.argtypes = ([p] * 4 + [i] * 6
                                               + [ctypes.c_float, i, i, p])
    lib.flash_attention_fwd_launch.restype = i
    lib.flash_attention_max_head_dim.restype = i
    return lib


def _flash_attention_cuda(q, k, v, *, causal: bool, scale: float):
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v must share a device; got {dev}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [b, h, sq, d] and k, v [b, hk, sk, d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, hk, sk, dk = k.shape
    if k.shape[0] != b or dk != d or hk < 1 or h % hk != 0:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes f32 or bf16, one dtype for q, k, v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash kernel inputs must be contiguous")
    lib = _lib()
    if d > lib.flash_attention_max_head_dim() or sk < 1:
        raise ValueError(f"flash kernel takes 1 <= d <= "
                         f"{lib.flash_attention_max_head_dim()} and sk >= 1; "
                         f"got d={d}, sk={sk}")
    if causal and sq > sk:
        raise ValueError(f"causal flash attention needs sq <= sk; got sq={sq}, sk={sk}")
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hk, sq, sk, d, float(scale), int(causal),
            _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {rc}")
    flash_attention_fwd.launches += 1
    return out


def _work(out, q, k, v, causal: bool, scale: float):
    b, h, sq, d = q.shape
    return flash_work(b, h, k.shape[1], sq, k.shape[2], d, causal, q.element_size())


@kernel_call("flash_attention_fwd", _work)
def _forward(q, k, v, causal: bool, scale: float):
    if q.device.type == "cuda":
        return _flash_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal, scale=scale)
    if q.device.type == "meta":         # the dry run: shapes only, nothing runs
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {q.device}")
    return flash_attention_torch(q, k, v, causal=causal, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the reference's recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _forward(q.detach(), k.detach(), v.detach(), causal, scale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(need)
                       for t, need in zip(saved, ctx.needs_input_grad))
            out = chunked_attention(q, k, v, causal=ctx.causal, scale=ctx.scale)
            wrt = [t for t in (q, k, v) if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(got) if t.requires_grad else None for t in (q, k, v)),
                None, None)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """Attention forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable on both (the backward is the
    plain version's VJP).  Returns [b, h, sq, d] in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _FlashAttention.apply(q, k, v, causal, scale)


flash_attention_fwd.launches = 0
