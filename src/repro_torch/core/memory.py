"""Message construction (Eq. 4-5) and the GRU memory updater (Eq. 7-10).

Port of ``repro.core.memory``. Weights are packed as in the reference:
W_i (f_mail, 3*f_mem), W_h (f_mem, 3*f_mem), gate order [r | z | n]. The
message is ``s_self || s_other || f_e || Phi(dt)``; the mailbox keeps the
raw part and Phi(dt) is appended when the mail is consumed (cosine
encoder). With the LUT encoder the time contribution is folded: the
GRU-folded LUT row ``(table @ W_i[time rows])[bucket(dt)]`` is added to the
input projection instead of concatenating Phi(dt).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils import FrozenConfig, tenant_matmul
from repro_torch.core import time_encode as te


@dataclasses.dataclass(frozen=True)
class GRUConfig(FrozenConfig):
    f_mem: int = 100
    f_edge: int = 172
    f_time: int = 100

    @property
    def f_mail_raw(self) -> int:
        return 2 * self.f_mem + self.f_edge

    @property
    def f_mail(self) -> int:
        return self.f_mail_raw + self.f_time


def dense_init(generator: torch.Generator, shape, device,
               scale: float | None = None) -> torch.Tensor:
    """LeCun-normal init for dense kernels (fan_in, fan_out...)."""
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0], 1))
    return (torch.randn(tuple(shape), generator=generator) * scale).to(device)


def init_gru(generator: torch.Generator, cfg: GRUConfig, device) -> dict:
    return {
        "w_i": dense_init(generator, (cfg.f_mail, 3 * cfg.f_mem), device),
        "w_h": dense_init(generator, (cfg.f_mem, 3 * cfg.f_mem), device),
        "b_i": torch.zeros((3 * cfg.f_mem,), device=device),
        "b_h": torch.zeros((3 * cfg.f_mem,), device=device),
    }


def _gates(gi: torch.Tensor, gh: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    f_mem = s.shape[-1]
    i_r, i_z, i_n = gi[..., :f_mem], gi[..., f_mem:2 * f_mem], gi[..., 2 * f_mem:]
    h_r, h_z, h_n = gh[..., :f_mem], gh[..., f_mem:2 * f_mem], gh[..., 2 * f_mem:]
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * s


def gru_cell(params: dict, mail: torch.Tensor, s: torch.Tensor,
             tenants: int = 1) -> torch.Tensor:
    """GRU cell on the whole message. mail (B, f_mail), s (B, f_mem) ->
    (B, f_mem); the products run each of ``tenants`` blocks of rows on
    its own (``utils.tenant_matmul``)."""
    return _gates(tenant_matmul(mail, params["w_i"], tenants) + params["b_i"],
                  tenant_matmul(s, params["w_h"], tenants) + params["b_h"], s)


def gru_cell_lut(params: dict, mail_raw: torch.Tensor,
                 time_rows: torch.Tensor, s: torch.Tensor,
                 tenants: int = 1) -> torch.Tensor:
    """GRU cell with the time contribution pre-projected (LUT-fused path).

    ``mail_raw`` (B, f_mail_raw); ``time_rows`` (B, 3*f_mem) LUT rows folded
    through W_i[time rows]; ``s`` (B, f_mem) -> (B, f_mem). ``tenants`` as
    in ``gru_cell``.
    """
    n_raw = mail_raw.shape[-1]
    return _gates(tenant_matmul(mail_raw, params["w_i"][:n_raw], tenants)
                  + params["b_i"] + time_rows,
                  tenant_matmul(s, params["w_h"], tenants) + params["b_h"], s)


def build_mail_raw(s_self: torch.Tensor, s_other: torch.Tensor,
                   f_e: torch.Tensor) -> torch.Tensor:
    """Raw cached message (Eq. 4-5 minus the time encoding)."""
    return torch.cat([s_self, s_other, f_e], dim=-1)


def update_memory(gru_params: dict, time_params: dict, cfg: GRUConfig,
                  mail_raw: torch.Tensor, mail_ts: torch.Tensor,
                  mail_valid: torch.Tensor, s: torch.Tensor,
                  last_update: torch.Tensor, *, encoder: str = "cosine",
                  lut_folded: dict | None = None, tenants: int = 1):
    """Consume cached messages: s' = UPDT(mail, s) (Alg. 1 lines 3-5).
    dt = mail_ts - last_update; vertices without valid mail keep their
    memory. Returns (s_new, last_update_new). ``tenants``: the rows are
    that many tenants' equal blocks (``gru_cell``)."""
    dt = mail_ts - last_update
    if encoder == "cosine":
        mail = torch.cat([mail_raw, te.cosine_encode(time_params, dt)],
                         dim=-1)
        s_new = gru_cell(gru_params, mail, s, tenants)
    elif encoder == "lut":
        folded = lut_folded
        if folded is None:
            folded = te.fold_projection(time_params,
                                        gru_params["w_i"][cfg.f_mail_raw:])
        s_new = gru_cell_lut(gru_params, mail_raw,
                             te.lut_encode(folded, dt), s, tenants)
    else:
        raise ValueError(f"unknown encoder {encoder!r}")
    s_out = torch.where(mail_valid[:, None], s_new, s)
    lu_out = torch.where(mail_valid, mail_ts, last_update)
    return s_out, lu_out
