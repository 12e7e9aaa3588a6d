"""The port's Qwen2 tokenizer reader (``utils/qwen_tokenizer.py``) against
``transformers.AutoTokenizer`` on the same directory.

The directory is built offline, once for the module, with ``tokenizers``:
a byte-level BPE trained on a seeded corpus, Qwen2's split pattern after an
NFC normalizer, a ByteLevel decoder, Qwen2.5's 22 added tokens after the
vocabulary (the first 14 special) and a ``tokenizer_config.json`` as
Qwen2.5-Instruct's. Held exactly: ids for both values of
``add_special_tokens`` over seeded strings (contractions in any case, digit
runs, runs of spaces, tabs and newlines, NFD accents, CJK, emoji, special
tokens inline, Unicode spaces), ``decode`` with and without
``skip_special_tokens`` (also of every prefix of a multi-byte run, where
partial UTF-8 becomes U+FFFD), ``len``, ``vocab_size``, the pad and eos ids,
the ids ``add_tokens(TRAIN_SPECIAL_TOKENS)`` gives, truncation, and the
prompts ``build_prompting_from_config`` makes; a ``tokenizer.json`` without
added tokens encodes as ``tokenizers`` does; a ``tokenizer.json`` of
another structure (or a config that cleans up spaces) is refused. ``transformers`` is imported in this file
only: ``launch.load_tokenizer`` reads the directory without it.
"""
import copy
import json
import pathlib
import unicodedata

import numpy as np
import pytest

from unigen_tpu_torch import launch as TL
from unigen_tpu_torch.utils import configuration as TC
from unigen_tpu_torch.utils.qwen_tokenizer import QWEN2_PATTERN, QwenTokenizer, split_words

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPECIAL = ("<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
           "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
           "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
           "<|image_pad|>", "<|video_pad|>")
NOT_SPECIAL = ("<tool_call>", "</tool_call>", "<|fim_prefix|>", "<|fim_middle|>",
               "<|fim_suffix|>", "<|fim_pad|>", "<|repo_name|>", "<|file_sep|>")
WORDS = ("the", "The", "cat", "sat", "on", "a", "mat", "photo", "of", "red", "apple", "two",
         "dogs", "café", "naïve", "Zürich", "日本語", "東京タワー", "한국어", "Привет",
         "مرحبا", "😀", "🚀🚀", "👍🏽", "x=1;", "foo_bar", "C++", "e-mail", "3.14", "2024",
         "100000")
PIECES = {
    "contractions": ("don't", "DON'T", "I'm", "we'RE", "they've", "You'll", "she'd", "it's",
                     "'S", "'ſ", "rock'n'roll", "'tis", "o'clock"),
    "digits": ("1", "12", "123456789", "3.14159", "v2", "x86_64", "0x1F", "1,000,000", "½", "²"),
    "spaces": (" ", "  ", "   ", "\t", "\n", "\n\n", " \n ", "\r\n", "  \t\n", "\u00a0",
               "\u3000", "\u2009", "\u2028", "\x0b", "\x85", "\x1c"),
    "accents": ("cafe\u0301", "nai\u0308ve", "A\u030a", "e\u0301\u0301", "\u1100\u1161",
                "\u212b", "\u2126", "\ufb01", "caf\u00e9"),
    "cjk_emoji": ("日本語", "中文字符", "ひらがな", "😀", "\U0001f469\u200d\U0001f469\u200d\U0001f467",
                  "🇯🇵", "∑∫", "♥\ufe0f"),
    "specials": SPECIAL[:3] + NOT_SPECIAL[:3] + ("<|im_start|>user\n", "<|endoftext|><|im_end|>",
                                                  "<|im_start", "|>"),
}


def _strings(kind, n=25, seed=0):
    rng = np.random.default_rng(100 * seed + sorted(PIECES).index(kind))
    out = []
    for _ in range(n):
        parts = [str(rng.choice(PIECES[kind] if rng.random() < 0.6 else WORDS))
                 for _ in range(int(rng.integers(1, 8)))]
        seps = [str(rng.choice(("", " ", "  ", "\n", "!", "? ", ". "))) for _ in parts]
        out.append("".join(p + s for p, s in zip(parts, seps)))
    return out


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    rng = np.random.default_rng(0)
    corpus = [" ".join(rng.choice(WORDS, 12)) + str(rng.choice(("\n", "  ", ". ")))
              for _ in range(400)]
    corpus += [s for kind in PIECES for s in _strings(kind, 20, seed=100)]
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=700, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False) for s in SPECIAL])
    tok.add_tokens([AddedToken(s, special=False, normalized=False) for s in NOT_SPECIAL])
    root = tmp_path_factory.mktemp("qwen") / "Qwen2.5-1.5B-Instruct"
    root.mkdir()
    tok.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
        "pad_token": "<|endoftext|>", "model_max_length": 131072, "bos_token": None,
        "unk_token": None, "clean_up_tokenization_spaces": False, "errors": "replace",
        "split_special_tokens": False, "add_prefix_space": False}))
    return root


@pytest.fixture(scope="module")
def pair(tok_dir):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(str(tok_dir)), QwenTokenizer.from_pretrained(str(tok_dir))


@pytest.mark.parametrize("kind", sorted(PIECES))
def test_ids_and_decode_match_hf(pair, kind):
    hf, ours = pair
    for s in _strings(kind):
        for add in (True, False):
            want = hf(s, add_special_tokens=add)["input_ids"]
            assert ours(s, add_special_tokens=add)["input_ids"] == want, (s, add)
        for skip in (False, True):
            assert ours.decode(want, skip_special_tokens=skip) == \
                hf.decode(want, skip_special_tokens=skip), (s, skip)
    batch = _strings(kind, 5, seed=7)
    assert ours(batch)["input_ids"] == hf(batch)["input_ids"]


def test_split_words_matches_the_pattern():
    import regex
    pat = regex.compile(QWEN2_PATTERN)
    for kind in PIECES:
        for s in _strings(kind, 40, seed=3):
            s = unicodedata.normalize("NFC", s)
            assert split_words(s) == pat.findall(s), s


def test_partial_utf8_and_sizes_match_hf(pair, tok_dir):
    from transformers import AutoTokenizer
    hf, ours = pair
    ids = hf("😀日本 👩‍👩‍👧é")["input_ids"]
    for k in range(len(ids) + 1):
        for part in (ids[:k], ids[k:], ids[k:k + 1]):
            assert ours.decode(part) == hf.decode(part), part
    assert (len(ours), ours.vocab_size, ours.pad_token_id, ours.eos_token_id) == \
        (len(hf), hf.vocab_size, hf.pad_token_id, hf.eos_token_id)
    assert ours.eos_token_id == ours.vocab_size + 2 and ours.pad_token_id == ours.vocab_size
    text = "a b c d e f g h i j"
    short = (AutoTokenizer.from_pretrained(str(tok_dir), model_max_length=5),
             QwenTokenizer.from_pretrained(str(tok_dir), model_max_length=5))
    assert [t(text, truncation=True)["input_ids"] for t in short] == \
        [hf(text)["input_ids"][:5]] * 2
    assert ours.convert_tokens_to_ids(["<|im_start|>", "nope"]) == \
        hf.convert_tokens_to_ids(["<|im_start|>", "nope"])


def test_added_tokens_and_prompting_match_hf(tok_dir):
    """``add_tokens(TRAIN_SPECIAL_TOKENS)`` and the prompts of
    ``build_prompting_from_config`` (the flagship SFT config, pointed at the
    directory through ``model.ckpt_base_path``)."""
    from transformers import AutoTokenizer
    conf = TC.initialize_config(str(ROOT / "configs/unigen_1_5b/unigen_sft.yaml"),
                                [f"model.ckpt_base_path={tok_dir.parent}"])
    ours = TL.load_tokenizer(conf)
    hf = AutoTokenizer.from_pretrained(str(tok_dir), model_max_length=32768,
                                       padding_side="right")
    assert isinstance(ours, QwenTokenizer) and ours.model_max_length == 32768
    tp = TL.build_prompting_from_config(conf, ours)
    hp = TL.build_prompting_from_config(conf, hf)
    assert tp.sptids_dict == hp.sptids_dict and len(ours) == len(hf)
    assert hf.convert_tokens_to_ids(list(TL.TRAIN_SPECIAL_TOKENS)) == \
        ours.convert_tokens_to_ids(list(TL.TRAIN_SPECIAL_TOKENS)) == \
        list(range(ours.vocab_size + 22, ours.vocab_size + 31))
    prompts = ["a photo of a red cat", "two dogs; don't   stop\n", "日本の 😀"]
    img = np.full((3, 16), 7, np.int64)
    for got, want in zip(tp((prompts, img, 32), "t2i_gen"), hp((prompts, img, 32), "t2i_gen")):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tp((img, prompts), "mmu"), hp((img, prompts), "mmu")):
        np.testing.assert_array_equal(got, want)
    s = "<|im_start|><|t2i|>user\na cat<|soi|><|eoi|><|im_end|>"
    ids = hf(s)["input_ids"]
    assert ours(s)["input_ids"] == ids
    assert ours.decode(ids, skip_special_tokens=True) == hf.decode(ids, skip_special_tokens=True)
    assert ours.add_tokens(["<|soi|>", "brand_new"]) == hf.add_tokens(["<|soi|>", "brand_new"]) == 1
    assert len(ours) == len(hf) and ours("x brand_new y")["input_ids"] == \
        hf("x brand_new y")["input_ids"]


@pytest.mark.parametrize("change", ["model", "normalizer", "pattern", "decoder", "post",
                                    "lstrip", "clean_up"])
def test_other_tokenizer_json_is_refused(tok_dir, tmp_path, change):
    spec = json.loads((tok_dir / "tokenizer.json").read_text())
    bad = copy.deepcopy(spec)
    if change == "model":
        bad["model"] = {"type": "WordPiece", "vocab": {"a": 0}, "unk_token": "[UNK]"}
    elif change == "normalizer":
        bad["normalizer"] = {"type": "NFKC"}
    elif change == "pattern":
        bad["pre_tokenizer"]["pretokenizers"][0]["pattern"] = {"Regex": r"\s+|\S+"}
    elif change == "decoder":
        bad["decoder"] = {"type": "WordPiece", "prefix": "##", "cleanup": True}
    elif change == "post":
        bad["post_processor"] = {"type": "TemplateProcessing", "single": [], "pair": [],
                                 "special_tokens": {}}
    elif change == "lstrip":
        bad["added_tokens"][0]["lstrip"] = True
    else:
        (tmp_path / "tokenizer_config.json").write_text(
            json.dumps({"clean_up_tokenization_spaces": True}))
    (tmp_path / "tokenizer.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="Qwen2 tokenizer.json"):
        QwenTokenizer.from_pretrained(str(tmp_path))


def test_no_added_tokens_encodes_as_tokenizers(tok_dir, tmp_path):
    """A ``tokenizer.json`` whose ``added_tokens`` is empty: the reader
    encodes and decodes as ``tokenizers`` does on the same file, and
    ``add_tokens`` then numbers from the base vocabulary."""
    from tokenizers import Tokenizer
    spec = json.loads((tok_dir / "tokenizer.json").read_text())
    spec["added_tokens"] = []
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    hf = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    ours = QwenTokenizer.from_pretrained(str(tmp_path))
    assert len(ours) == ours.vocab_size == hf.get_vocab_size()
    for kind in ("accents", "contractions", "digits", "spaces"):
        for s in _strings(kind, 10, seed=5):
            ids = hf.encode(s).ids
            assert ours(s)["input_ids"] == ids, s
            assert ours.decode(ids) == hf.decode(ids), s
    assert ours.add_tokens(["<|soi|>"]) == 1 and ours("a<|soi|>")["input_ids"][-1] == \
        ours.vocab_size
