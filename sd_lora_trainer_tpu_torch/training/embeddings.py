"""Textual-inversion token engine.

Counterpart of sd_lora_trainer_tpu/training/embeddings.py. The new tokens
`<s0>..<sN>` are registered in both tokenizers and their rows are trainable
tensors of their own; the frozen token tables never see a gradient.

`initialize_new_tokens` draws the rows: per encoder, N(0, 1) rows from an
explicit `torch.Generator` (the JAX package folds a key), rescaled so each
row's std matches the table's mean per-row std, and the table's
`DistributionLossTargets`. `TokenEmbeddingsHandler` adds the tokenizers:
registration, the caption analysis for the DAAM loss (`ti_token_positions`),
the embeddings file (`{name}_{version}_embeddings.safetensors`, keys clip_l
and clip_g) and the nearest-token diagnostics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sd_lora_trainer_tpu_torch.diffusion.losses import DistributionLossTargets
from sd_lora_trainer_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors

# the TI rows' keys in the embeddings file, per encoder (CLIP-L, OpenCLIP-bigG)
TXT_ENCODER_KEYS = ["clip_l", "clip_g"]


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


@dataclasses.dataclass
class TokenEmbeddingsHandler:
    tokenizers: List[Optional[object]]
    inserting_toks: List[str] = dataclasses.field(default_factory=list)
    train_ids: Optional[List[int]] = None
    # per encoder index (0, 1): the table's mean per-row std and loss targets
    std_token_embedding: Dict[int, float] = dataclasses.field(default_factory=dict)
    distribution_targets: Dict[int, DistributionLossTargets] = dataclasses.field(
        default_factory=dict)

    def initialize_new_tokens(
        self,
        token_tables: List[Optional[torch.Tensor]],
        inserting_toks: List[str],
        generator: torch.Generator,
        starting_rows: Optional[List[Optional[torch.Tensor]]] = None,
    ) -> List[Optional[torch.Tensor]]:
        """Register the tokens in each tokenizer and return the trainable
        fp32 rows per encoder (None where there is no encoder).
        `starting_rows` replaces the draws (the tests feed JAX's)."""
        self.inserting_toks = list(inserting_toks)
        tables = [t if tok is not None else None for tok, t in zip(self.tokenizers, token_tables)]
        rows, targets = initialize_new_tokens(tables, len(self.inserting_toks), generator)
        for idx, (tokenizer, table) in enumerate(zip(self.tokenizers, tables)):
            if tokenizer is None or table is None:
                continue
            tokenizer.add_special_tokens(self.inserting_toks)
            self.train_ids = tokenizer.convert_tokens_to_ids(self.inserting_toks)
            self.std_token_embedding[idx] = float(table.float().std(dim=1, correction=0).mean())
            self.distribution_targets[idx] = targets[f"te{idx + 1}"]
            if starting_rows is not None and starting_rows[idx] is not None:
                start = starting_rows[idx]
                start = (start.detach().float().clone() if torch.is_tensor(start)
                         else torch.from_numpy(np.array(start, np.float32)))
                rows[idx] = start.to(table.device).requires_grad_()
        return rows

    def save_embeddings(self, ti_rows: List[Optional[torch.Tensor]], file_path: str) -> None:
        if self.train_ids is None:
            raise ValueError("initialize new tokens before saving embeddings")
        save_safetensors({TXT_ENCODER_KEYS[i]: rows.detach().float()
                          for i, rows in enumerate(ti_rows) if rows is not None}, file_path)

    @staticmethod
    def load_embeddings(file_path: str) -> Dict[str, torch.Tensor]:
        sd = load_safetensors(file_path)
        out = {}
        for idx, key in enumerate(TXT_ENCODER_KEYS):
            for k in (key, f"text_encoders_{idx}"):  # the second: the legacy name
                if k in sd:
                    out[key] = sd[k]
                    break
        return out

    @staticmethod
    def nearest_tokens(rows: torch.Tensor, table: torch.Tensor, tokenizer,
                       k: int = 5) -> List[List[str]]:
        """The k nearest vocab tokens (cosine) of each trained row."""
        rows, table = rows.detach().float(), table.detach().float().to(rows.device)
        rn = rows / (torch.linalg.norm(rows, dim=1, keepdim=True) + 1e-8)
        tn = table / (torch.linalg.norm(table, dim=1, keepdim=True) + 1e-8)
        top = torch.argsort(-(rn @ tn.T), dim=1)[:, :k].cpu().tolist()
        decoder = {v: t for t, v in tokenizer.encoder.items()}
        return [[decoder.get(int(i), "?") for i in row] for row in top]

    def print_token_info(self, ti_rows: List[Optional[torch.Tensor]],
                         token_tables: List[Optional[torch.Tensor]]) -> None:
        """Each new token's std against its target, and its neighbours."""
        for idx, (rows, table) in enumerate(zip(ti_rows, token_tables)):
            if rows is None or table is None or self.tokenizers[idx] is None:
                continue
            stds = rows.detach().float().std(dim=1, correction=0).cpu().tolist()
            neighbors = self.nearest_tokens(rows, table, self.tokenizers[idx])
            for i, tok in enumerate(self.inserting_toks):
                print(f"  te{idx + 1} {tok}: std={stds[i]:.4f} "
                      f"(target {self.std_token_embedding.get(idx, 0):.4f}) "
                      f"neighbors={neighbors[i]}")

    def ti_token_positions(self, caption: str, tokenizer_idx: int = 0):
        """(token count, [position of each TI token or -1]) of one caption:
        the host-side analysis the token-attention loss reads."""
        ids = self.tokenizers[tokenizer_idx].encode(caption)
        return len(ids), [ids.index(t) if t in ids else -1 for t in self.train_ids]
