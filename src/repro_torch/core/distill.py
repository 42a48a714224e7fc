"""Knowledge distillation (Eq. 17) and the self-supervised link losses.

Port of ``repro.core.distill``. The student (SAT [+LUT] [+NP]) learns from
two signals:

  1. self-supervision from temporal edges: BCE on positive (src, dst)
     pairs against negative (src, random dst) pairs, through the link head;
  2. a soft cross-entropy between the student's simplified attention
     logits alpha-bar' = a + W_t * dt and the teacher's vanilla attention
     logits alpha-bar (Eq. 17), at temperature T (the paper's T = 1):

         l_a = - sum_v Softmax(abar(v)/T) . log Softmax(abar'(v)/T)

     with the teacher's distribution as the target; invalid neighbour
     slots are masked.

The teacher's logits are detached, as the reference stops their gradient;
the row maxima that shift the softmaxes are detached too, which changes no
value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

from repro_torch.utils import NEG_INF


def masked_log_softmax(logits: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    masked = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = masked.max(dim=-1, keepdim=True).values
    shifted = masked - m.detach()
    lse = torch.log((torch.exp(shifted) * valid).sum(dim=-1, keepdim=True)
                    + 1e-30)
    return shifted - lse


def attn_distill_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, valid: torch.Tensor,
                      temperature: float = 1.0) -> torch.Tensor:
    """Eq. 17: soft cross-entropy between attention score distributions.

    student_logits, teacher_logits, valid: (B, m_r). Rows with no valid
    neighbour contribute zero. The loss is scaled by T^2, which keeps the
    gradient's size comparable across temperatures (Hinton et al. 2015).
    """
    t = float(temperature)
    neg = torch.full_like(student_logits, NEG_INF)
    teacher_p = torch.where(
        valid,
        torch.softmax(torch.where(valid, teacher_logits.detach() / t, neg),
                      dim=-1),
        torch.zeros_like(student_logits))
    student_logp = masked_log_softmax(student_logits / t, valid)
    per_row = -(teacher_p * torch.where(valid, student_logp,
                                        torch.zeros_like(student_logp))
                ).sum(dim=-1)
    has_valid = valid.any(dim=-1)
    denom = has_valid.sum().clamp(min=1)
    return (t * t) * torch.where(has_valid, per_row,
                                 torch.zeros_like(per_row)).sum() / denom


def bce_link_loss(pos_scores: torch.Tensor,
                  neg_scores: torch.Tensor) -> torch.Tensor:
    """Self-supervised temporal link prediction BCE (Section II)."""
    return 0.5 * (tnf.softplus(-pos_scores).mean()
                  + tnf.softplus(neg_scores).mean())


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 valid: torch.Tensor, pos_scores: torch.Tensor,
                 neg_scores: torch.Tensor, *, temperature: float = 1.0,
                 kd_weight: float = 1.0):
    """The student's objective: link BCE + kd_weight * l_a. Returns
    ``(total, {"link", "kd", "total"})``."""
    l_link = bce_link_loss(pos_scores, neg_scores)
    l_a = attn_distill_loss(student_logits, teacher_logits, valid,
                            temperature)
    total = l_link + kd_weight * l_a
    return total, {"link": l_link, "kd": l_a, "total": total}


def average_precision(pos_scores: torch.Tensor,
                      neg_scores: torch.Tensor) -> torch.Tensor:
    """AP for balanced positive/negative link prediction (the paper's
    accuracy metric): sort every score descending, then average the
    precision at each positive. The sort is stable, as the reference's
    ``jnp.argsort``, so tied scores keep positives before negatives."""
    scores = torch.cat([pos_scores, neg_scores])
    labels = torch.cat([torch.ones_like(pos_scores),
                        torch.zeros_like(neg_scores)])
    order = torch.sort(-scores, stable=True).indices
    lab = labels[order]
    cum_tp = torch.cumsum(lab, dim=0)
    ranks = torch.arange(1, lab.shape[0] + 1, dtype=torch.float32,
                         device=lab.device)
    precision_at = cum_tp / ranks
    n_pos = lab.sum().clamp(min=1.0)
    return (precision_at * lab).sum() / n_pos
