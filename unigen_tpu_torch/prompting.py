"""Task-sequence assembly (numpy only).

The port's own copy of ``unigen_tpu.prompting.UniPrompting``, as far as the
``t2i_gen`` task, the discrete ``mmu`` task and the continuous (SigLIP)
``mmu_conv`` task need it.
Layouts (identical to the JAX package):

  t2i_gen   [pad...][task/<|im_start|>user\\n][text][<|im_end|>\\n<|im_start|>assistant\\n]
            [<|soi|>][N image tokens][<|eoi|>]                         (left-pad)
  mmu       [<|im_start|>][<|mmu|>][<|soi|>][N image tokens][<|eoi|>][text][<|im_end|>]
            [pad...]                                                   (right-pad)
  mmu_conv  part1 = [sys?][<|im_start|>][<|mmu|>][<|soi|>],
            part2 = [<|eoi|>][conversation ids without their first token];
            the caller splices the image embeddings between the two.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_SPECIAL_TOKENS = (
    "<|soi|>", "<|eoi|>", "<|sov|>", "<|eov|>", "<|t2i|>",
    "<|mmu|>", "<|t2v|>", "<|think_start|>", "<|think_end|>",
)
IGNORE_ID = -100  # label of positions without a training target


class UniPrompting:
    """Unified prompting over a HuggingFace-style text tokenizer.

    The tokenizer must provide ``__call__``, ``add_tokens``,
    ``convert_tokens_to_ids``, ``pad_token_id``, ``eos_token_id`` and
    ``__len__`` (``launch.FallbackTokenizer`` does). The special tokens are
    added to the vocabulary and the task token follows ``<|im_start|>``, as
    every UniGen stage config sets it (``task_token_first: false``).
    """

    def __init__(self, text_tokenizer,
                 special_tokens: Sequence[str] = DEFAULT_SPECIAL_TOKENS,
                 max_seq_len: Optional[int] = None):
        self.text_tokenizer = text_tokenizer
        self.pad_id = int(text_tokenizer.pad_token_id)
        self.eos_token_id = int(text_tokenizer.eos_token_id)
        self.max_seq_len = max_seq_len
        text_tokenizer.add_tokens(list(special_tokens))
        self.sptids_dict: Dict[str, int] = {
            tok: int(text_tokenizer.convert_tokens_to_ids([tok])[0])
            for tok in (*special_tokens, "<|im_start|>", "<|im_end|>")}
        self.sptids_dict["<|pad|>"] = self.pad_id

    def _tokenize(self, texts) -> List[List[int]]:
        out = self.text_tokenizer(texts)["input_ids"]
        if isinstance(texts, str):
            return [out]
        return [list(ids) for ids in out]

    def _conv_start_ids(self, task_token: str) -> List[int]:
        return list(self._tokenize(f"<|im_start|>{task_token}user\n")[0])

    def _conv_end_ids(self) -> List[int]:
        return list(self._tokenize("<|im_end|>\n<|im_start|>assistant\n")[0])

    def t2i_gen_prompt(self, texts: Sequence[str], image_ids: np.ndarray,
                       max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Left-padded generation prompts: (input_ids, attention_mask)."""
        text_ids = self._tokenize(list(texts))
        n_img = image_ids.shape[1]
        soi, eoi = self.sptids_dict["<|soi|>"], self.sptids_dict["<|eoi|>"]
        conv_start = self._conv_start_ids("<|t2i|>")
        conv_end = self._conv_end_ids()
        if max_len is None:
            max_len = max(len(t) for t in text_ids) + len(conv_start) + len(conv_end) + 2 + n_img
        else:
            max_len = max_len + len(conv_start) + len(conv_end) + 2 + n_img
        max_len = min(max_len, self.max_seq_len)

        seqs, masks = [], []
        for i in range(len(text_ids)):
            body = conv_start + text_ids[i] + conv_end
            if max_len >= len(body) + n_img + 2:
                pad_n = max_len - len(body) - n_img - 2
                mask = [0] * pad_n + [1] * (len(body) + n_img + 2)
                body = [self.pad_id] * pad_n + body
            else:
                mask = [1] * max_len
                # clamp: a text budget smaller than the template would otherwise
                # go negative and emit ragged rows
                body = body[: max(0, max_len - n_img - 2 - len(conv_end))] + conv_end
                body = body[: max_len - n_img - 2]
            seqs.append(body + [soi] + list(image_ids[i]) + [eoi])
            masks.append(mask)
        return np.asarray(seqs, np.int64), np.asarray(masks, np.int64)

    def mmu_prompt(self, image_ids: np.ndarray, texts: Sequence[str]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Right-padded sequences over discrete image tokens (already offset
        into the unified vocabulary), padded to ``max_seq_len``: (input_ids,
        attention_mask, labels). The text is cut to fit; labels mark the
        head, the image block, ``<|eoi|>`` and the pads with ``IGNORE_ID``."""
        text_ids = self._tokenize(list(texts))
        n_img = image_ids.shape[1]
        sp = self.sptids_dict
        head = [sp["<|im_start|>"], sp["<|mmu|>"], sp["<|soi|>"]]
        seqs, masks, labs = [], [], []
        for i, ids in enumerate(text_ids):
            free = self.max_seq_len - n_img - 5
            if free >= len(ids):
                mask = [1] * (len(ids) + n_img + 5) + [0] * (free - len(ids))
                body = ids + [sp["<|im_end|>"]] + [self.pad_id] * (free - len(ids))
            else:
                mask = [1] * self.max_seq_len
                body = ids[:free] + [sp["<|im_end|>"]]
            lab = [IGNORE_ID] * (n_img + 4) + body
            labs.append([IGNORE_ID if t == self.pad_id else t for t in lab])
            seqs.append(head + list(image_ids[i]) + [sp["<|eoi|>"]] + body)
            masks.append(mask)
        return (np.asarray(seqs, np.int64), np.asarray(masks, np.int64),
                np.asarray(labs, np.int64))

    def _eos_scan(self, part2: np.ndarray, extra_len: int, total_len: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row valid length from the last eos (``<|im_end|>``) of part2;
        a row without one counts part2's length alone, as the reference does."""
        b, l2 = part2.shape
        attn = np.zeros((b, total_len), dtype=bool)
        pos = np.zeros((b, total_len), dtype=np.int64)
        for i in range(b):
            hits = np.flatnonzero(part2[i] == self.eos_token_id)
            cur_len = l2 - (l2 - 1 - hits[-1]) + extra_len if len(hits) else l2
            cur_len = min(cur_len, total_len)
            attn[i, :cur_len] = True
            pos[i, :cur_len] = np.arange(cur_len)
        return attn, pos

    def mmu_conv(self, images: np.ndarray, input_ids: np.ndarray,
                 label_ids: Optional[np.ndarray], input_ids_system: Optional[np.ndarray]):
        """Conversation assembly around continuous image embeddings.

        ``images`` [B, N, D] gives only the image length N. Returns
        (part1, part2, attention [B, max_seq_len] bool, labels)."""
        if images.ndim != 3:
            raise NotImplementedError("mmu_conv over discrete image ids is not ported yet")
        img_seq_len = images.shape[1]
        b = input_ids.shape[0]
        if label_ids is None:
            label_ids = input_ids.copy()
        sp = self.sptids_dict
        part1 = np.tile(np.asarray([sp["<|im_start|>"], sp["<|mmu|>"], sp["<|soi|>"]],
                                   np.int64), (b, 1))
        part2 = np.concatenate([np.full((b, 1), sp["<|eoi|>"], np.int64), input_ids[:, 1:]],
                               axis=1)
        head = [np.full((b, 3 + img_seq_len + 1), IGNORE_ID, np.int64), label_ids[:, 1:]]
        if input_ids_system is not None:
            if input_ids_system.shape[0] == 1 and b > 1:
                input_ids_system = np.tile(input_ids_system, (b, 1))
            part1 = np.concatenate([input_ids_system, part1], axis=1)
            head = [np.full_like(input_ids_system, IGNORE_ID)] + head
        labels = np.concatenate(head, axis=1)
        attn, _ = self._eos_scan(part2, part1.shape[1] + img_seq_len, self.max_seq_len)
        return part1, part2, attn, labels

    def __call__(self, inputs, task: str):
        if task == "t2i_gen":
            max_len = None if len(inputs) == 2 else inputs[2]
            return self.t2i_gen_prompt(inputs[0], np.asarray(inputs[1]), max_len)
        if task == "mmu":
            return self.mmu_prompt(np.asarray(inputs[0]), inputs[1])
        if task == "mmu_conv":
            return self.mmu_conv(np.asarray(inputs[0]), np.asarray(inputs[1]),
                                 None if inputs[2] is None else np.asarray(inputs[2]),
                                 None if inputs[3] is None else np.asarray(inputs[3]))
        raise NotImplementedError(f"task {task!r} is not ported yet")
