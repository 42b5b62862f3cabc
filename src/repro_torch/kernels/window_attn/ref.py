"""Plain PyTorch version of causal sliding-window attention: the dense
masked softmax of ``repro.kernels.window_attn.ref.window_attention_ref``,
in the model's (B, S, H, hd) layout with GQA.  Its backward is autograd.

For bfloat16 operands it follows the TPU kernel's bf16 arithmetic (its
wrapper's contract: the result in q's dtype): the logits and the softmax in
float32 from the widened operands, P = exp(s - max) rounded to bf16 before
P V, the sum over the unrounded P."""
import torch


def window_attention_ref(q, k, v, window: int):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd), query head h reading kv head
    h // (H // KV).  Query i attends keys j with i - window < j <= i at
    scale hd^-1/2.  Returns (B, S, H, hd) in q's dtype (f32 or bf16)."""
    b, s, h, hd = q.shape
    nkv = k.shape[2]
    qg = q.float().reshape(b, s, nkv, h // nkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    ok = (kp <= qp) & (kp > qp - window)
    logits = torch.where(ok, logits, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    if q.dtype != torch.bfloat16:
        p = p / p.sum(-1, keepdim=True)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
        return out.reshape(b, s, h, hd)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    out = pv / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, hd).to(q.dtype)
