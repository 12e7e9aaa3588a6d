"""A Qwen2 tokenizer directory, read without ``transformers`` or ``tokenizers``.

The JAX package's ``load_tokenizer`` hands a tokenizer directory to
``transformers.AutoTokenizer``; the port depends on neither that package
nor ``tokenizers`` nor ``regex``, which the machine with the card need not
have. ``QwenTokenizer.from_pretrained`` reads ``tokenizer.json`` (and
``tokenizer_config.json`` for ``eos_token``, ``pad_token`` and
``model_max_length``; Qwen2's ``clean_up_tokenization_spaces`` is false, and
true raises) and gives the surface of HF's fast tokenizer that the port calls:
``__call__(text | list, add_special_tokens=, truncation=)["input_ids"]``,
``decode(ids, skip_special_tokens=)``, ``add_tokens``,
``convert_tokens_to_ids``, ``pad_token_id``, ``eos_token_id``,
``vocab_size`` (the base vocabulary) and ``len()`` (with the added tokens).

Only Qwen2's structure is taken, and anything else raises ``ValueError``:

1. the added tokens are split out first, leftmost-longest: those with
   ``normalized: false`` on the raw text, then, after the normalizer, those
   with ``normalized: true``;
2. an NFC normalizer;
3. a ``Split`` pre-tokenizer on Qwen2's pattern (``QWEN2_PATTERN``, matches
   isolated), written out by hand over ``unicodedata`` (Python's ``re`` has
   no ``\\p{..}`` classes): ``\\p{L}`` / ``\\p{N}`` are the L* / N* general
   categories and ``\\s`` is Oniguruma's (tab to CR, NEL, and the Zs, Zl and
   Zp categories); then ``ByteLevel`` without a prefix space;
4. a BPE model whose merges are applied by rank, with a per-word cache;
5. a ``ByteLevel`` decoder: a token whose characters all map to bytes gives
   those bytes, any other token its UTF-8, and the bytes are decoded with
   U+FFFD for each invalid sequence.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CACHE_WORDS = 10_000          # HF's BPE cache holds as many words
# the contractions of the pattern's first group, by the letters after the
# apostrophe, and the letters Unicode case folding maps onto them
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_FOLDS = {"ſ": "s"}
_ONIG_SPACE = frozenset("\t\n\x0b\x0c\r\x85")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map, which ByteLevel uses."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_CHARS = bytes_to_unicode()
_CHAR_BYTES = {c: b for b, c in _BYTE_CHARS.items()}


def _char_class(c: str) -> str:
    """'L' letter, 'N' number, 'R' CR or LF, 'W' other whitespace, 'O' the rest."""
    if c == "\r" or c == "\n":
        return "R"
    cat = unicodedata.category(c)
    if cat[0] in "LN":
        return cat[0]
    if c in _ONIG_SPACE or cat in ("Zs", "Zl", "Zp"):
        return "W"
    return "O"


def split_words(text: str) -> List[str]:
    """``text`` cut as Qwen2's ``Split`` pre-tokenizer cuts it: the matches
    of ``QWEN2_PATTERN`` (which match every character), alternatives tried
    in order at each position as a backtracking engine tries them."""
    n = len(text)
    cls = [_char_class(c) for c in text]
    words, i = [], 0
    while i < n:
        k = cls[i]
        # (?i:'s|'t|'re|'ve|'m|'ll|'d)
        if text[i] == "'":
            nxt = "".join(_FOLDS.get(c, c) for c in text[i + 1:i + 3]).lower()
            hit = next((c for c in _CONTRACTIONS if nxt.startswith(c)), None)
            if hit is not None:
                words.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        # [^\r\n\p{L}\p{N}]?\p{L}+
        j = i + 1 if k in "WO" and i + 1 < n and cls[i + 1] == "L" else i
        if cls[j] == "L":
            j += 1
            while j < n and cls[j] == "L":
                j += 1
            words.append(text[i:j])
            i = j
            continue
        # \p{N}
        if k == "N":
            words.append(text[i])
            i += 1
            continue
        # ` ?[^\s\p{L}\p{N}]+[\r\n]*`
        j = i + 1 if text[i] == " " and i + 1 < n and cls[i + 1] == "O" else i
        if cls[j] == "O":
            j += 1
            while j < n and cls[j] == "O":
                j += 1
            while j < n and cls[j] == "R":
                j += 1
            words.append(text[i:j])
            i = j
            continue
        # whitespace from here: \s*[\r\n]+ | \s+(?!\S) | \s+
        end = i
        while end < n and cls[end] in "RW":
            end += 1
        last = max((m for m in range(i, end) if cls[m] == "R"), default=-1)
        if last >= 0:
            j = last + 1
        elif end == n or end - i == 1:
            j = end
        else:
            j = end - 1
        words.append(text[i:j])
        i = j
    return words


def _token_content(value) -> Optional[str]:
    """A token of tokenizer_config.json: a string, an AddedToken dict or null."""
    return value.get("content") if isinstance(value, dict) else value


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"not a Qwen2 tokenizer.json: {what}")


class QwenTokenizer:
    """Qwen2's byte-level BPE tokenizer (module docstring)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 added_tokens: Sequence[dict], eos_token: Optional[str] = None,
                 pad_token: Optional[str] = None, model_max_length: Optional[int] = None):
        self.vocab = dict(vocab)
        self.ranks = {tuple(pair): r for r, pair in enumerate(merges)}
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.added: Dict[str, int] = {}
        self.special: set = set()
        self.normalized: set = set()
        self._splitters = None
        for tok in added_tokens:
            for flag in ("single_word", "lstrip", "rstrip"):
                _require(not tok.get(flag, False), f"added token {tok['content']!r} has {flag}")
            self._add(tok["content"], int(tok["id"]), bool(tok.get("special", False)),
                      bool(tok.get("normalized", not tok.get("special", False))))
        self.eos_token, self.pad_token = eos_token, pad_token
        self.model_max_length = int(model_max_length) if model_max_length else int(1e30)
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_pretrained(cls, path: str, model_max_length: Optional[int] = None
                        ) -> "QwenTokenizer":
        """A directory's ``tokenizer.json`` and ``tokenizer_config.json``;
        ``model_max_length`` overrides the config's, as it does for
        ``AutoTokenizer.from_pretrained``."""
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        conf = {}
        conf_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(conf_path):
            with open(conf_path, encoding="utf-8") as f:
                conf = json.load(f)
        model = spec.get("model") or {}
        _require(model.get("type") == "BPE", f"model {model.get('type')!r}, not BPE")
        for key, want in (("dropout", None), ("unk_token", None), ("fuse_unk", False),
                          ("byte_fallback", False), ("ignore_merges", False)):
            _require(model.get(key, want) == want, f"BPE {key} {model.get(key)!r}")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            _require(not model.get(key), f"BPE {key} {model.get(key)!r}")
        _require((spec.get("normalizer") or {}).get("type") == "NFC", "the normalizer is not NFC")
        pre = spec.get("pre_tokenizer") or {}
        steps = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" else [pre]
        _require(len(steps) == 2 and steps[0].get("type") == "Split"
                 and steps[0].get("pattern") == {"Regex": QWEN2_PATTERN}
                 and steps[0].get("behavior") == "Isolated" and not steps[0].get("invert"),
                 "the pre-tokenizer is not a Split on Qwen2's pattern")
        _require(steps[1].get("type") == "ByteLevel" and not steps[1].get("add_prefix_space")
                 and not steps[1].get("use_regex", True),
                 "the Split is not followed by a ByteLevel without prefix space or regex")
        _require((spec.get("decoder") or {}).get("type") == "ByteLevel",
                 "the decoder is not ByteLevel")
        _require(not conf.get("clean_up_tokenization_spaces", False),
                 "tokenizer_config.json sets clean_up_tokenization_spaces")
        post = spec.get("post_processor")
        _require(post is None or post.get("type") == "ByteLevel",
                 f"post-processor {post and post.get('type')!r} adds tokens")
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        return cls(model["vocab"], merges, spec.get("added_tokens", []),
                   eos_token=_token_content(conf.get("eos_token")),
                   pad_token=_token_content(conf.get("pad_token")),
                   model_max_length=model_max_length or conf.get("model_max_length"))

    # -- vocabulary -----------------------------------------------------------

    def _add(self, content: str, idx: int, special: bool, normalized: bool) -> None:
        self.added[content] = idx
        self.id_to_token[idx] = content
        if special:
            self.special.add(content)
        if normalized:
            self.normalized.add(content)
        self._splitters = None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __len__(self) -> int:
        return len(set(self.vocab) | set(self.added))

    def add_tokens(self, tokens: Union[str, Sequence[str]]) -> int:
        """Non-special tokens, matched after normalization as HF adds them; a
        token of the base vocabulary keeps its id. Returns how many are new."""
        new = 0
        for tok in [tokens] if isinstance(tokens, str) else tokens:
            if tok in self.added:
                continue
            idx = self.vocab.get(tok)
            if idx is None:
                top = max(self.added.values(), default=-1)
                idx = top + 1 if top >= self.vocab_size else self.vocab_size
                new += 1
            self._add(tok, idx, special=False, normalized=True)
        return new

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.added.get(tokens, self.vocab.get(tokens))
        return [self.convert_tokens_to_ids(t) for t in tokens]

    @property
    def pad_token_id(self) -> Optional[int]:
        return None if self.pad_token is None else self.convert_tokens_to_ids(self.pad_token)

    @property
    def eos_token_id(self) -> Optional[int]:
        return None if self.eos_token is None else self.convert_tokens_to_ids(self.eos_token)

    # -- encode ---------------------------------------------------------------

    def _splitter(self, normalized: bool):
        if self._splitters is None:
            pats = []
            for want in (False, True):
                toks = sorted((t for t in self.added if (t in self.normalized) == want),
                              key=len, reverse=True)
                pats.append(re.compile("|".join(re.escape(t) for t in toks)) if toks else None)
            self._splitters = pats
        return self._splitters[normalized]

    def _split_added(self, text: str, normalized: bool) -> List[Tuple[str, bool]]:
        """(piece, is an added token) in order, leftmost-longest."""
        pat = self._splitter(normalized)
        if pat is None:
            return [(text, False)] if text else []
        out, at = [], 0
        for m in pat.finditer(text):
            if m.start() > at:
                out.append((text[at:m.start()], False))
            out.append((m.group(), True))
            at = m.end()
        if at < len(text):
            out.append((text[at:], False))
        return out

    def _bpe(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        symbols = list(word)
        while len(symbols) > 1:
            best = min(((self.ranks[p], i) for i, p in enumerate(zip(symbols, symbols[1:]))
                        if p in self.ranks), default=None)
            if best is None:
                break
            pair = (symbols[best[1]], symbols[best[1] + 1])
            merged, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == pair:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        try:
            ids = [self.vocab[s] for s in symbols]
        except KeyError as e:
            raise ValueError(f"symbol {e.args[0]!r} of {word!r} is not in the vocabulary") from None
        if len(self._cache) < CACHE_WORDS:
            self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for raw, is_tok in self._split_added(text, normalized=False):
            if is_tok:
                ids.append(self.added[raw])
                continue
            for piece, is_tok in self._split_added(unicodedata.normalize("NFC", raw), True):
                if is_tok:
                    ids.append(self.added[piece])
                    continue
                for word in split_words(piece):
                    ids.extend(self._bpe("".join(_BYTE_CHARS[b] for b in word.encode("utf-8"))))
        return ids

    def __call__(self, texts, add_special_tokens: bool = True, truncation: bool = False):
        """{"input_ids": ids} of a string, or a list of them for a list. Qwen2
        adds no special tokens, so ``add_special_tokens`` changes nothing;
        ``truncation`` cuts on the right at ``model_max_length``."""
        limit = self.model_max_length if truncation else None

        def one(text):
            return self.encode(text)[:limit]
        if isinstance(texts, str):
            return {"input_ids": one(texts)}
        return {"input_ids": [one(t) for t in texts]}

    # -- decode ---------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = bytearray()
        for i in ([ids] if isinstance(ids, int) else ids):
            tok = self.id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            if all(c in _CHAR_BYTES for c in tok):
                out.extend(_CHAR_BYTES[c] for c in tok)
            else:
                out.extend(tok.encode("utf-8"))
        return out.decode("utf-8", "replace")
