"""Task-sequence assembly (numpy only).

The port's own copy of ``unigen_tpu.prompting``: ``UniPrompting`` (the
Qwen2 ChatML engine, every task) and ``UniPromptingLegacy`` (the pre-Qwen2
engine with the video tasks). ``UniPrompting``'s layouts (identical to the
JAX package; with ``task_token_first`` the task token comes before
``<|im_start|>``):

  t2i       the t2i_gen layout at ``max_seq_len``, with labels and the
            conditioning dropout (an explicit ``numpy.random.Generator``)
  t2i_gen   [pad...][task/<|im_start|>user\\n][text][<|im_end|>\\n<|im_start|>assistant\\n]
            [<|soi|>][N image tokens][<|eoi|>]                         (left-pad)
  lm        [<|im_start|>][text][<|im_end|>][pad...]                   (right-pad)
  mmu       [<|im_start|>][<|mmu|>][<|soi|>][N image tokens][<|eoi|>][text][<|im_end|>]
            [pad...]                                                   (right-pad)
  mmu_conv  part1 = [sys?][<|im_start|>][<|mmu|>][<|soi|>],
            part2 = [<|eoi|>][conversation ids without their first token];
            the caller splices the image embeddings between the two (discrete
            image ids: returned spliced).
  mmu_emb   prefix = [task/<|im_start|>user\n][<|soi|>], suffix = [image pads]
            [<|eoi|>][text][<|im_end|>][pad...]; the image length from [B, N, ...]
            embeddings or NaFlex [B, 2] spatial shapes
  lm_conv   the attention and positions of a conversation up to its last eos
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
    added to the vocabulary. ``task_token_first`` orders the head tokens:
    ``[task][<|im_start|>]`` when True, ``[<|im_start|>][task]`` when False,
    as every UniGen stage config sets it. ``enable_reuse_tk`` maps
    ``<|soi|>`` / ``<|sov|>`` to Qwen's own ``<|vision_start|>`` and
    ``<|eoi|>`` / ``<|eov|>`` to ``<|vision_end|>`` instead of adding them.
    ``ignore_id`` labels the positions without a training target.
    """

    def __init__(self, text_tokenizer,
                 special_tokens: Sequence[str] = DEFAULT_SPECIAL_TOKENS,
                 max_seq_len: Optional[int] = None, task_token_first: bool = False,
                 enable_reuse_tk: bool = False, cond_dropout_prob: float = 0.1,
                 rng: Optional[np.random.Generator] = None, ignore_id: int = IGNORE_ID):
        self.task_token_first = task_token_first
        self.enable_reuse_tk = enable_reuse_tk
        self.ignore_id = ignore_id
        self.text_tokenizer = text_tokenizer
        self.pad_id = int(text_tokenizer.pad_token_id)
        self.max_seq_len = max_seq_len
        self.cond_dropout_prob = cond_dropout_prob
        self.rng = rng or np.random.default_rng(0)
        special_tokens = list(special_tokens)
        self.sptids_dict: Dict[str, int] = {}
        if enable_reuse_tk:
            for tok, alias in (("<|soi|>", "<|vision_start|>"), ("<|eoi|>", "<|vision_end|>"),
                               ("<|sov|>", "<|vision_start|>"), ("<|eov|>", "<|vision_end|>")):
                if tok in special_tokens:
                    special_tokens.remove(tok)
                    self.sptids_dict[tok] = int(text_tokenizer.convert_tokens_to_ids([alias])[0])
        text_tokenizer.add_tokens(special_tokens)
        for tok in (*special_tokens, "<|im_start|>", "<|im_end|>"):
            self.sptids_dict[tok] = int(text_tokenizer.convert_tokens_to_ids([tok])[0])
        self.sptids_dict["<|pad|>"] = self.pad_id
        self.bos_token_id = self.sptids_dict["<|im_start|>"]
        self.eos_token_id = int(text_tokenizer.eos_token_id)

    def _tokenize(self, texts, truncation: bool = False) -> List[List[int]]:
        out = self.text_tokenizer(texts, **({"truncation": True} if truncation else {}))[
            "input_ids"]
        if isinstance(texts, str):
            return [out]
        return [list(ids) for ids in out]

    def _conv_start_ids(self, task_token: str) -> List[int]:
        if self.task_token_first:
            return list(self._tokenize(f"{task_token}<|im_start|>user\n")[0])
        return list(self._tokenize(f"<|im_start|>{task_token}user\n")[0])

    def _head(self) -> List[int]:
        """[task][im_start][soi] or [im_start][task][soi] of the mmu tasks."""
        sp = self.sptids_dict
        first = [sp["<|mmu|>"], sp["<|im_start|>"]]
        return (first if self.task_token_first else first[::-1]) + [sp["<|soi|>"]]

    def _conv_end_ids(self) -> List[int]:
        return list(self._tokenize("<|im_end|>\n<|im_start|>assistant\n")[0])

    def t2i_prompt(self, texts: Sequence[str], image_ids: np.ndarray, labels: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Left-padded t2i training sequences at ``max_seq_len``: (input_ids,
        attention_mask, labels). A row's text is dropped with probability
        ``cond_dropout_prob`` (one draw of ``rng`` a row)."""
        ign = self.ignore_id
        text_ids = self._tokenize(list(texts))
        n_img = image_ids.shape[1]
        soi, eoi = self.sptids_dict["<|soi|>"], self.sptids_dict["<|eoi|>"]
        conv_start = self._conv_start_ids("<|t2i|>")
        conv_end = self._conv_end_ids()
        drop = self.rng.random(len(text_ids)) < self.cond_dropout_prob
        seqs, masks, labs = [], [], []
        for i in range(len(text_ids)):
            body = conv_start + ([] if drop[i] else text_ids[i]) + conv_end
            if self.max_seq_len >= len(body) + n_img + 2:
                pad_n = self.max_seq_len - len(body) - n_img - 2
                mask = [0] * pad_n + [1] * (len(body) + n_img + 2)
                body = [self.pad_id] * pad_n + body
            else:
                mask = [1] * self.max_seq_len
                body = body[: self.max_seq_len - n_img - 2]
            lab = [ign] * len(body) + [soi] + list(labels[i]) + [eoi]
            labs.append([ign if t == self.pad_id else t for t in lab])
            seqs.append(body + [soi] + list(image_ids[i]) + [eoi])
            masks.append(mask)
        return (np.asarray(seqs, np.int64), np.asarray(masks, np.int64),
                np.asarray(labs, np.int64))

    def lm_prompt(self, texts: Sequence[str], max_seq_len: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Right-padded language-modelling sequences: (input_ids,
        attention_mask, labels); the pads' labels are ``ignore_id``."""
        sp = self.sptids_dict
        seqs, masks, labs = [], [], []
        for ids in self._tokenize(list(texts), truncation=True):
            body = [sp["<|im_start|>"]] + ids + [sp["<|im_end|>"]]
            if max_seq_len >= len(body):
                free = max_seq_len - len(body)
                lab = body + [self.ignore_id] * free
                mask = [1] * len(body) + [0] * free
                body = body + [self.pad_id] * free
            else:
                body = body[:max_seq_len]
                lab = list(body)
                mask = [1] * max_seq_len
            seqs.append(body)
            masks.append(mask)
            labs.append(lab)
        return (np.asarray(seqs, np.int64), np.asarray(masks, np.int64),
                np.asarray(labs, np.int64))

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
        head, the image block, ``<|eoi|>`` and the pads with ``ignore_id``."""
        ign = self.ignore_id
        text_ids = self._tokenize(list(texts))
        n_img = image_ids.shape[1]
        sp = self.sptids_dict
        head = self._head()
        seqs, masks, labs = [], [], []
        for i, ids in enumerate(text_ids):
            free = self.max_seq_len - n_img - 5
            if free >= len(ids):
                mask = [1] * (len(ids) + n_img + 5) + [0] * (free - len(ids))
                body = ids + [sp["<|im_end|>"]] + [self.pad_id] * (free - len(ids))
            else:
                mask = [1] * self.max_seq_len
                body = ids[:free] + [sp["<|im_end|>"]]
            lab = [ign] * (n_img + 4) + body
            labs.append([ign if t == self.pad_id else t for t in lab])
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
        """Conversation assembly around an image block.

        ``images`` [B, N, D] (continuous embeddings) gives only the image
        length N: returns (part1, part2, attention [B, max_seq_len] bool,
        labels). ``images`` [B, N] (discrete ids, already in the unified
        vocabulary) returns (part1 + images + part2, attention, labels)."""
        img_seq_len = images.shape[1]
        b = input_ids.shape[0]
        if label_ids is None:
            label_ids = input_ids.copy()
        sp = self.sptids_dict
        part1 = np.tile(np.asarray(self._head(), np.int64), (b, 1))
        part2 = np.concatenate([np.full((b, 1), sp["<|eoi|>"], np.int64), input_ids[:, 1:]],
                               axis=1)
        ign = self.ignore_id
        head = [np.full((b, 3 + img_seq_len + 1), ign, np.int64), label_ids[:, 1:]]
        if input_ids_system is not None:
            if input_ids_system.shape[0] == 1 and b > 1:
                input_ids_system = np.tile(input_ids_system, (b, 1))
            part1 = np.concatenate([input_ids_system, part1], axis=1)
            head = [np.full_like(input_ids_system, ign)] + head
        labels = np.concatenate(head, axis=1)
        attn, _ = self._eos_scan(part2, part1.shape[1] + img_seq_len, self.max_seq_len)
        if images.ndim == 2:
            return np.concatenate([part1, images.astype(np.int64), part2], axis=1), attn, labels
        return part1, part2, attn, labels

    def mmu_embed(self, image_shapes, texts: Sequence[str]):
        """Prefix / suffix ids for the continuous-embedding path: (prefix,
        suffix, attention_mask, labels). ``image_shapes``: [B, N, ...]
        embeddings (N image positions a row) or NaFlex [B, 2] spatial shapes
        (h * w a row). The suffix starts with the image's pad ids, which the
        caller overwrites with the embeddings; each text must hold
        ``<|im_end|>``, and the labels supervise what follows its first one."""
        image_shapes = np.asarray(image_shapes)
        if image_shapes.ndim == 3:
            img_seq_len = [image_shapes.shape[1]] * image_shapes.shape[0]
        else:
            img_seq_len = (image_shapes[:, 0] * image_shapes[:, 1]).tolist()
        text_ids = self._tokenize(list(texts))
        if self.task_token_first:
            conv_start = list(self._tokenize("<|mmu|><|im_start|>user\n<|soi|>")[0])
        else:
            conv_start = list(self._tokenize("<|im_start|><|mmu|>user\n<|soi|>")[0])
        conv_end = self._conv_end_ids()
        sp, ign = self.sptids_dict, self.ignore_id
        prefix, suffix, masks, labs = [], [], [], []
        for i, ids in enumerate(text_ids):
            body = [sp["<|eoi|>"]] + ids
            eos_pos = body.index(sp["<|im_end|>"]) + len(conv_end)
            n_valid = len(body) + img_seq_len[i] + len(conv_start) + 1
            if self.max_seq_len >= n_valid:
                mask = [1] * n_valid + [0] * (self.max_seq_len - n_valid)
                body = body + [sp["<|im_end|>"]] + [self.pad_id] * (self.max_seq_len - n_valid)
            else:
                mask = [1] * self.max_seq_len
                body = body[: self.max_seq_len - img_seq_len[i] - len(conv_start)]
            lab = [ign] * (len(conv_start) + img_seq_len[i] + eos_pos) + body[eos_pos:]
            labs.append([ign if t == self.pad_id else t for t in lab])
            suffix.append([self.pad_id] * img_seq_len[i] + body)
            prefix.append(conv_start)
            masks.append(mask)
        return (np.asarray(prefix, np.int64), np.asarray(suffix, np.int64),
                np.asarray(masks, np.int64), np.asarray(labs, np.int64))

    def lm_conv(self, input_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(attention [B, max_seq_len] bool, positions) of conversations up
        to each row's last eos (all of a row without one)."""
        return self._eos_scan(input_ids, 0, self.max_seq_len)

    def __call__(self, inputs, task: str):
        if task == "t2i":
            return self.t2i_prompt(inputs[0], np.asarray(inputs[1]), np.asarray(inputs[2]))
        if task == "lm":
            return self.lm_prompt(inputs[0], inputs[1])
        if task == "t2i_gen":
            max_len = None if len(inputs) == 2 else inputs[2]
            return self.t2i_gen_prompt(inputs[0], np.asarray(inputs[1]), max_len)
        if task == "mmu":
            return self.mmu_prompt(np.asarray(inputs[0]), inputs[1])
        if task == "lm_conv":
            return self.lm_conv(np.asarray(inputs))
        if task == "mmu_conv":
            return self.mmu_conv(np.asarray(inputs[0]), np.asarray(inputs[1]),
                                 None if inputs[2] is None else np.asarray(inputs[2]),
                                 None if inputs[3] is None else np.asarray(inputs[3]))
        if task == "mmu_emb":
            return self.mmu_embed(inputs[0], inputs[1])
        raise NotImplementedError(task)


class UniPromptingLegacy:
    """The pre-Qwen2 (Llama/Phi-era) prompt engine, including the video tasks:
    the port's copy of the JAX package's ``UniPromptingLegacy`` (the
    reference's ``UniversalPrompting``, training/prompting_utils.py:426-973).

    Layouts use raw bos/eos instead of ChatML templates:
      t2i / lvg  [pad...][<task>][bos][text][eos][<|soi|>][img][<|eoi|>]
      t2v        same with <|t2v|> and <|sov|>/<|eov|> video markers (:630-682)
      lm         [bos][text][eos][pad...]                              (:543-575)
      mmu        [<|mmu|>][<|soi|>][img][<|eoi|>][bos][text][eos][pad...] (:577-628)
      mmu_conv   part1=[sys?][<|mmu|>][<|soi|>], part2=[<|eoi|>][conv ids] (:815-852)
      mmu_embed  prefix=[<|mmu|>][<|soi|>], suffix=[<|eoi|>][text]     (:854-898)

    Known reference bugs NOT reproduced (all in dead code paths there):
      - attention masks computed after padding, so their length disagrees with the
        sequence (e.g. :471-473 emits max_text_len+n+3 mask bits for a
        max_text_len+n+2 sequence; :553-563 marks right-pad positions valid).
        Here masks always align with the emitted sequence.
      - mmu_embed's per-row [B,N] ignore block (:886) would crash; fixed to [N].
    Golden-parity tests therefore assert on input_ids/labels, not masks.
    """

    def __init__(self, text_tokenizer,
                 special_tokens: Sequence[str] = ("<|soi|>", "<|eoi|>", "<|sov|>",
                                                  "<|eov|>", "<|t2i|>", "<|mmu|>",
                                                  "<|t2v|>", "<|v2v|>", "<|lvg|>"),
                 max_text_len: int = 8000, max_seq_len: Optional[int] = None,
                 ignore_id: int = IGNORE_ID, cond_dropout_prob: float = 0.1,
                 rng: Optional[np.random.Generator] = None):
        self.text_tokenizer = text_tokenizer
        if text_tokenizer.pad_token_id is None:
            text_tokenizer.add_special_tokens({"pad_token": "[PAD]"})
        text_tokenizer.add_tokens(list(special_tokens))
        self.sptids_dict: Dict[str, int] = {
            tok: int(text_tokenizer.convert_tokens_to_ids([tok])[0])
            for tok in special_tokens}
        self.bos_token_id = int(text_tokenizer.bos_token_id)
        self.eos_token_id = int(text_tokenizer.eos_token_id)
        self.pad_id = int(text_tokenizer.pad_token_id)
        self.sptids_dict["<|sot|>"] = self.bos_token_id
        self.sptids_dict["<|eot|>"] = self.eos_token_id
        self.sptids_dict["<|pad|>"] = self.pad_id
        # +1 because a task token is prepended (reference :442-443)
        self.max_text_len = max_text_len + 1
        self.ignore_id = ignore_id
        self.cond_dropout_prob = cond_dropout_prob
        self.max_seq_len = (max_seq_len if max_seq_len is not None
                            else getattr(text_tokenizer, "model_max_length", 2048))
        self.rng = rng or np.random.default_rng(0)

    # -- helpers ------------------------------------------------------------

    def _tokenize_raw(self, texts, truncation: bool = False) -> List[List[int]]:
        kw = {"truncation": True} if truncation else {}
        out = self.text_tokenizer(texts, **kw)["input_ids"]
        if texts and isinstance(texts, str):
            out = [out]
        return [list(ids) for ids in out]

    @staticmethod
    def _with_bos(ids: List[int], bos: int) -> List[int]:
        # ensure bos at front, bos alone for empties (reference :457-461)
        if not ids:
            return [bos]
        if ids[0] != bos:
            return [bos] + ids
        return ids

    def _tokenize(self, texts, truncation: bool = False) -> List[List[int]]:
        return [self._with_bos(ids, self.bos_token_id)
                for ids in self._tokenize_raw(texts, truncation)]

    def _padded_text(self, ids: List[int]) -> Tuple[List[int], int]:
        """Left-pad (or truncate+eos) a [task][bos][text][eos] row to max_text_len;
        returns (row, n_pad) (reference :471-477)."""
        if self.max_text_len >= len(ids):
            n_pad = self.max_text_len - len(ids)
            return [self.pad_id] * n_pad + ids, n_pad
        return ids[: self.max_text_len - 1] + [self.eos_token_id], 0

    def _gen_block(self, texts, task_token: str, s_tok: int, e_tok: int,
                   image_ids: np.ndarray, max_len: Optional[int] = None):
        """Shared body of the *_gen prompts: [pad][task][bos][text][eos][s][img][e]
        (reference t2i_gen_prompt :505-540, t2v_gen_prompt :684-716,
        lvg_gen_prompt :780-812)."""
        raw = self._tokenize_raw(list(texts))
        if max_len is not None and max_len < 0:
            # budget measured over raw (pre-bos-fix) lengths (:512-514)
            max_len = max(len(t) for t in raw) + 3
        text_ids = [self._with_bos(ids, self.bos_token_id) for ids in raw]
        seqs, masks = [], []
        for i, ids in enumerate(text_ids):
            row = [self.sptids_dict[task_token]] + ids + [self.eos_token_id]
            budget = max_len if max_len is not None else self.max_text_len
            if budget >= len(row):
                n_pad = budget - len(row)
                row = [self.pad_id] * n_pad + row
            else:
                n_pad = 0
                row = row[: budget - 1] + [self.eos_token_id]
            seqs.append(row + [s_tok] + list(image_ids[i]) + [e_tok])
            masks.append([0] * n_pad
                         + [1] * (len(row) - n_pad + image_ids.shape[1] + 2))
        return np.asarray(seqs, np.int64), np.asarray(masks, np.int64)

    # -- training prompts -----------------------------------------------------

    def _gen_train_block(self, texts, task_token: str, s_tok: int, e_tok: int,
                         image_ids: np.ndarray, labels: np.ndarray,
                         label_text: bool):
        """Shared body of t2i/t2v/lvg training prompts (reference :450-503 t2i,
        :630-682 t2v, :724-778 lvg). ``label_text`` matches the reference: t2i
        ignores text positions in labels (:480-486), t2v/lvg supervise them
        (:663-669, :755-761)."""
        text_ids = self._tokenize(list(texts))
        drop = self.rng.random(len(text_ids)) < self.cond_dropout_prob
        task = self.sptids_dict[task_token]
        seqs, masks, labs = [], [], []
        for i, ids in enumerate(text_ids):
            row = [task] + ids + [self.eos_token_id]
            if drop[i]:
                row = [task, self.bos_token_id, self.eos_token_id]
            row, n_pad = self._padded_text(row)
            text_part = list(row) if label_text else [self.ignore_id] * len(row)
            lab = text_part + [s_tok] + list(labels[i]) + [e_tok]
            lab = [self.ignore_id if t == self.pad_id else int(t) for t in lab]
            seqs.append(row + [s_tok] + list(image_ids[i]) + [e_tok])
            masks.append([0] * n_pad + [1] * (len(row) - n_pad
                                              + image_ids.shape[1] + 2))
            labs.append(lab)
        return (np.asarray(seqs, np.int64), np.asarray(masks, np.int64),
                np.asarray(labs, np.int64))

    def t2i_prompt(self, texts, image_ids, labels):
        return self._gen_train_block(texts, "<|t2i|>", self.sptids_dict["<|soi|>"],
                                     self.sptids_dict["<|eoi|>"], image_ids, labels,
                                     label_text=False)

    def t2v_prompt(self, texts, video_ids, labels):
        return self._gen_train_block(texts, "<|t2v|>", self.sptids_dict["<|sov|>"],
                                     self.sptids_dict["<|eov|>"], video_ids, labels,
                                     label_text=True)

    def lvg_prompt(self, texts, image_ids, labels):
        # long-video-generation shares the t2i task token and image markers (:745)
        return self._gen_train_block(texts, "<|t2i|>", self.sptids_dict["<|soi|>"],
                                     self.sptids_dict["<|eoi|>"], image_ids, labels,
                                     label_text=True)

    def t2i_gen_prompt(self, texts, image_ids, max_len=None):
        return self._gen_block(texts, "<|t2i|>", self.sptids_dict["<|soi|>"],
                               self.sptids_dict["<|eoi|>"], image_ids, max_len)

    def t2v_gen_prompt(self, texts, video_ids):
        return self._gen_block(texts, "<|t2v|>", self.sptids_dict["<|sov|>"],
                               self.sptids_dict["<|eov|>"], video_ids)

    def lvg_gen_prompt(self, texts, image_ids):
        return self._gen_block(texts, "<|t2i|>", self.sptids_dict["<|soi|>"],
                               self.sptids_dict["<|eoi|>"], image_ids)

    def lm_prompt(self, texts, max_seq_len: int):
        """[bos][text][eos] right-padded; labels ignore the pad (reference :543-575)."""
        text_ids = self._tokenize(list(texts), truncation=True)
        seqs, masks, labs = [], [], []
        for ids in text_ids:
            row = ids + [self.eos_token_id]
            if max_seq_len >= len(row):
                lab = row + [self.ignore_id] * (max_seq_len - len(row))
                mask = [1] * len(row) + [0] * (max_seq_len - len(row))
                row = row + [self.pad_id] * (max_seq_len - len(row))
            else:
                row = row[:max_seq_len]
                lab = list(row)
                mask = [1] * max_seq_len
            seqs.append(row)
            masks.append(mask)
            labs.append(lab)
        return (np.asarray(seqs, np.int64), np.asarray(masks, np.int64),
                np.asarray(labs, np.int64))

    def mmu_prompt(self, image_ids, texts):
        """[<|mmu|>][<|soi|>][img][<|eoi|>][bos][text][eos][pad] (reference :577-628)."""
        text_ids = self._tokenize(list(texts))
        n_img = image_ids.shape[1]
        max_text_len = self.max_text_len - 1
        head = [self.sptids_dict["<|mmu|>"], self.sptids_dict["<|soi|>"]]
        seqs, masks, labs = [], [], []
        for i, ids in enumerate(text_ids):
            row = ids + [self.eos_token_id]
            if max_text_len >= len(row):
                n_valid = len(row)
                row = row + [self.pad_id] * (max_text_len - len(row))
            else:
                row = row[: max_text_len - 1] + [self.eos_token_id]
                n_valid = len(row)
            lab = [self.ignore_id] * (n_img + 3) + [
                self.ignore_id if t == self.pad_id else int(t) for t in row]
            seqs.append(head + list(image_ids[i]) + [self.sptids_dict["<|eoi|>"]] + row)
            masks.append([1] * (n_img + 3 + n_valid) + [0] * (len(row) - n_valid))
            labs.append(lab)
        return (np.asarray(seqs, np.int64), np.asarray(masks, np.int64),
                np.asarray(labs, np.int64))

    def mmu_conv(self, images, input_ids, label_ids, input_ids_system):
        """Conversation mmu without the ChatML im_start head (reference :815-852)."""
        images = np.asarray(images)
        discrete = images.ndim == 2
        img_seq_len = images.shape[1]
        b = input_ids.shape[0]
        if label_ids is None:
            label_ids = input_ids.copy()
        part1 = np.tile(np.asarray([[self.sptids_dict["<|mmu|>"],
                                     self.sptids_dict["<|soi|>"]]], np.int64), (b, 1))
        part2 = np.concatenate([np.full((b, 1), self.sptids_dict["<|eoi|>"], np.int64),
                                input_ids], axis=1)
        ign = self.ignore_id
        blocks = [np.full((b, 2), ign, np.int64),
                  np.full((b, img_seq_len), ign, np.int64),
                  np.full((b, 1), ign, np.int64), label_ids]
        if input_ids_system is not None:
            part1 = np.concatenate([input_ids_system, part1], axis=1)
            blocks.insert(0, np.full_like(input_ids_system, ign))
        labels = np.concatenate(blocks, axis=1)
        if discrete:
            full = np.concatenate([part1, images.astype(np.int64), part2], axis=1)
            return full, None, labels
        return part1, part2, None, labels

    def mmu_embed(self, images_embeddings, texts):
        """Prefix/suffix for continuous embeddings (reference :854-898; the
        reference's [B,N] ignore-block bug fixed to per-row [N])."""
        images_embeddings = np.asarray(images_embeddings)
        img_seq_len = images_embeddings.shape[1]
        text_ids = self._tokenize(list(texts))
        max_text_len = self.max_text_len - 1
        prefix = [self.sptids_dict["<|mmu|>"], self.sptids_dict["<|soi|>"]]
        prefixes, suffixes, labs = [], [], []
        for ids in text_ids:
            row = ids + [self.eos_token_id]
            if max_text_len >= len(row):
                row = row + [self.pad_id] * (max_text_len - len(row))
            else:
                row = row[: max_text_len - 1] + [self.eos_token_id]
            lab = [self.ignore_id] * (img_seq_len + 3) + [
                self.ignore_id if t == self.pad_id else int(t) for t in row]
            prefixes.append(prefix)
            suffixes.append([self.sptids_dict["<|eoi|>"]] + row)
            labs.append(lab)
        return (np.asarray(prefixes, np.int64), np.asarray(suffixes, np.int64),
                None, np.asarray(labs, np.int64))

    def __call__(self, inputs, task: str, config=None):
        """Task dispatch (reference :900-973)."""
        if task == "t2i":
            return self.t2i_prompt(inputs[0], np.asarray(inputs[1]), np.asarray(inputs[2]))
        if task == "t2v":
            return self.t2v_prompt(inputs[0], np.asarray(inputs[1]), np.asarray(inputs[2]))
        if task == "lvg":
            return self.lvg_prompt(inputs[0], np.asarray(inputs[1]), np.asarray(inputs[2]))
        if task == "t2i_plus_lm":
            bs = config if isinstance(config, int) else config.training.batch_size
            text_ids_all = list(inputs[0])
            return (self.t2i_prompt(text_ids_all[:bs], np.asarray(inputs[1]),
                                    np.asarray(inputs[2])),
                    self.lm_prompt(text_ids_all[bs:], inputs[3]))
        if task == "t2i_gen":
            max_len = None if len(inputs) == 2 else inputs[2]
            return self.t2i_gen_prompt(inputs[0], np.asarray(inputs[1]), max_len)
        if task == "t2v_gen":
            return self.t2v_gen_prompt(inputs[0], np.asarray(inputs[1]))
        if task == "lvg_gen":
            return self.lvg_gen_prompt(inputs[0], np.asarray(inputs[1]))
        if task == "lm":
            return self.lm_prompt(inputs[0], inputs[1])
        if task == "mmu":
            return self.mmu_prompt(np.asarray(inputs[0]), inputs[1])
        if task == "mmu_conv":
            return self.mmu_conv(inputs[0], np.asarray(inputs[1]),
                                 None if inputs[2] is None else np.asarray(inputs[2]),
                                 None if inputs[3] is None else np.asarray(inputs[3]))
        if task == "mmu_emb":
            return self.mmu_embed(inputs[0], inputs[1])
        raise NotImplementedError(task)
