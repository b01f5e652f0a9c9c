"""Textual-inversion rows from the frozen token tables.

The part of the JAX package's `TokenEmbeddingsHandler.initialize_new_tokens`
(training/embeddings.py:41-76) that needs no tokenizer: per encoder, new rows
drawn N(0, 1) and rescaled so each row's std matches the table's mean per-row
std, plus the `DistributionLossTargets` of the table. Registering the new
tokens with the tokenizers is the tokenizer slice's work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from sd_lora_trainer_tpu_torch.diffusion.losses import DistributionLossTargets


def initialize_new_tokens(
    token_tables: List[Optional[torch.Tensor]],  # frozen [V, D] per encoder
    n_tokens: int,
    generator: torch.Generator,
) -> Tuple[List[Optional[torch.Tensor]], Dict[str, DistributionLossTargets]]:
    """(trainable fp32 rows per encoder or None, {"te1"/"te2": targets})."""
    rows_out: List[Optional[torch.Tensor]] = []
    targets: Dict[str, DistributionLossTargets] = {}
    for idx, table in enumerate(token_tables):
        if table is None:
            rows_out.append(None)
            continue
        tablef = table.float()
        std_target = tablef.std(dim=1, correction=0).mean()
        targets[f"te{idx + 1}"] = DistributionLossTargets.from_embeddings(tablef)
        rows = torch.randn(n_tokens, table.shape[1], generator=generator,
                           dtype=torch.float32, device=table.device)
        rows = rows * std_target / rows.std(dim=1, correction=0).mean()
        rows_out.append(rows.detach().requires_grad_())
    return rows_out, targets
