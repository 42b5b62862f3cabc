"""Plain PyTorch version of causal sliding-window attention: the dense
masked softmax of ``repro.kernels.window_attn.ref.window_attention_ref``,
in the model's (B, S, H, hd) layout with GQA.  Its backward is autograd."""
import torch


def window_attention_ref(q, k, v, window: int):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd), query head h reading kv head
    h // (H // KV).  Query i attends keys j with i - window < j <= i at
    scale hd^-1/2.  Returns (B, S, H, hd) f32."""
    b, s, h, hd = q.shape
    nkv = k.shape[2]
    qg = q.float().reshape(b, s, nkv, h // nkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * hd ** -0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    ok = (kp <= qp) & (kp > qp - window)
    logits = torch.where(ok, logits, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, s, h, hd)
