"""Controls: the reference put in the program's place and computed in the
nearest precision below the one the configuration states. A control
must come out not correct under the same comparison the program passes.

- fp32 distances -> TF32: inputs of the distance product rounded to TF32
  (10-bit mantissa), products summed in fp32, as TF32 tensor cores do;
- an int8 scan -> int4: table rows quantized to int4 (one scale a row);
- bf16 weight products -> fp8: both inputs of every product of the
  embedder rounded to e4m3 with one scale a tensor, sums in fp32.

Imports nothing of the program."""
from __future__ import annotations

import numpy as np
import torch

# the nearest precision below a configuration's scan precision
BELOW = {"fp32": "tf32", "int8": "int4"}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest-even on TF32's 10-bit mantissa."""
    b = x.float().contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0xFFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def fp8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with both inputs rounded to float8 e4m3 (scaled by their
    largest magnitude to e4m3's range), summed in fp32."""
    def q(t):
        s = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return q(a) @ q(w)


def quantize_int4(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` rounded to int4 codes in [-7, 7] with one fp32 scale
    a row, returned dequantized."""
    s = x.abs().amax(1, keepdim=True).clamp_min(1e-30) / 7.0
    return torch.round(x / s).clamp_(-7, 7) * s


def sq_dists(q: torch.Tensor, x: torch.Tensor, *, tf32: bool = False
             ) -> torch.Tensor:
    """(G, D) x (N, D) squared distances by the quadratic expansion; with
    ``tf32`` the cross product's inputs are rounded to TF32."""
    qa, xa = (round_tf32(q), round_tf32(x)) if tf32 else (q, x)
    return ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
            - 2.0 * qa @ xa.T).clamp_min_(0.0)


def control_rows(queries: list, table: np.ndarray, numeric: dict, *,
                 precision: str, device, block: int = 64) -> list:
    """Each query (``reference.bruteforce`` form) answered with distances
    in the control's precision: "tf32" or "int4". Rows are logical ids,
    a V.K's rows in the control's distance order, as the program ranks
    them."""
    from perfbench.reference.bruteforce import evaluate
    x = torch.as_tensor(table, device=device)
    if precision == "int4":
        x = quantize_int4(x)
    out = []
    for i in range(0, len(queries), block):
        part = queries[i:i + block]
        qv = torch.as_tensor(np.stack([q["vec"] for q in part]),
                             device=device)
        d2 = sq_dists(qv, x, tf32=precision == "tf32").cpu().numpy()
        for q, d in zip(part, d2):
            rows = evaluate(q, d, numeric)
            if q.get("vk") is not None:
                rows = rows[np.argsort(d[rows], kind="stable")]
            out.append(rows)
    return out
