"""The rank programs of tests/test_torch_parallel.py and tests/test_torch_multihost.py.

``spawn(program, world, inputs_path, out_dir)`` starts ``world`` processes
on the CPU, joined by gloo over a TCP store on localhost, each with one
thread; every rank runs ``program(inputs, out_dir)`` after
``torch.distributed`` is up, and rank 0 writes what the test compares
(``save``). The programs import torch and the port only.
"""
import copy
import io
import os
import re
import socket
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from unigen_tpu_torch import parallel as P  # noqa: E402
from unigen_tpu_torch import weights as W  # noqa: E402
from unigen_tpu_torch.models import qwen2  # noqa: E402
from unigen_tpu_torch.models import siglip as TSG  # noqa: E402
from unigen_tpu_torch.models import unigen as TU  # noqa: E402
from unigen_tpu_torch.parallel import collectives as C  # noqa: E402
from unigen_tpu_torch.parallel import partition as PT  # noqa: E402
from unigen_tpu_torch.training import dpo as TD  # noqa: E402
from unigen_tpu_torch.training import lr_schedules as TLRS  # noqa: E402
from unigen_tpu_torch.training import optimizer as TO  # noqa: E402
from unigen_tpu_torch.training import sft as TSFT  # noqa: E402
from unigen_tpu_torch.training import train_step as TT  # noqa: E402
from unigen_tpu_torch.utils import checkpoint as CK  # noqa: E402
from unigen_tpu_torch.utils import multihost as MH  # noqa: E402
from unigen_tpu_torch.utils.persistence import _leaves  # noqa: E402


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(rank, world, port, program, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        inputs = torch.load(inputs_path, weights_only=False) if inputs_path else None
        globals()[program](inputs, out_dir)
        dist.barrier()
    except Exception:
        with open(os.path.join(out_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(program: str, world: int, inputs_path, out_dir: str) -> None:
    """The ranks fork from a fresh server process that has imported torch,
    the port and this module once (the forkserver, with those preloaded):
    a rank starts in a fraction of a second instead of importing them."""
    mp.set_forkserver_preload([__name__, "torch._dynamo"])
    mp.start_processes(_entry, args=(world, free_port(), program, inputs_path, out_dir),
                       nprocs=world, start_method="forkserver")


def save(out_dir: str, name: str, obj) -> None:
    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(out_dir, f"{name}.pt"))


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def _whole_state(state) -> dict:
    """{path: whole tensor} of a sharded TrainState (every rank gathers)."""
    specs = CK.state_specs(state)
    mesh = state.sharding.mesh
    return {p: PT.gather_full(t.detach(), specs[p], mesh)
            for p, t in _leaves(CK._to_tree(state))}


def _schedule(inp):
    name, kw = inp["schedule"]
    return TLRS.get_scheduler(name, **kw)


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------- programs --

def pt2(inp, out_dir):
    """The PT2 step at data 4 x model 2 against the unsharded step; the
    flagship's GQA layout (KV heads that do not divide) at model 4."""
    cfg, vq_cfg, tcfg = inp["cfg"], inp["vq_cfg"], inp["tcfg"]
    params, vq, batch, draws = inp["params"], inp["vq"], inp["batch"], inp["draws"]
    tx = TO.make_optimizer(params, 1e-3, _schedule(inp), max_grad_norm=1.0)
    step = TT.make_train_step(cfg, vq_cfg, tx, tcfg)
    whole, wm = step(TT.init_train_state(params, tx), vq, batch, draws)
    out = {"whole_metrics": _metrics(wm), "whole_params": whole.params}
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    specs = P.unigen_specs(params, cfg, mesh)
    local, sh = P.shard_params(params, specs, mesh)
    state, m = step(TT.init_train_state(local, tx, sharding=sh), vq, batch, draws)
    out.update(specs=specs, metrics=_metrics(m), params=P.gather_params(state.params, sh),
               q_local=tuple(state.params["llm"]["layers"][0]["q_w"].shape))
    # four query heads over two KV heads at model 4: one query head a rank,
    # k/v whole and sliced to the rank's KV head (the port's alignment rule)
    mesh4 = P.make_mesh(data=2, fsdp=1, model=4, device_type="cpu")
    specs4 = P.unigen_specs(params, cfg, mesh4)
    local4, sh4 = P.shard_params(params, specs4, mesh4)
    state4, m4 = step(TT.init_train_state(local4, tx, sharding=sh4), vq, batch, draws)
    out.update(specs4=specs4, metrics4=_metrics(m4),
               params4=P.gather_params(state4.params, sh4))
    save(out_dir, "pt2", out)


def sft(inp, out_dir, name="sft"):
    """The SFT step of each case at data 4 x model 2 (the tower sharded too)
    against the unsharded step; ``name`` "sft_lora": a tree with adapters,
    the adapters alone trained."""
    cfg, vq_cfg, vs_cfg = inp["cfg"], inp["vq_cfg"], inp["vs_cfg"]
    params, vq, vs, draws = (inp[k] for k in ("params", "vq", "vs", "draws"))
    out = {}
    for case, (batch, step_kw) in inp["cases"].items():
        tx = TO.make_optimizer(params, 1e-3, _schedule(inp), **inp["opt_kw"])
        step = TSFT.make_sft_train_step(cfg, vq_cfg, vs_cfg, tx,
                                        TSFT.SFTStepConfig(max_grad_norm=1.0, **step_kw))
        whole, wm = step(TSFT.init_sft_state(params, tx), vq, vs, batch, draws)
        mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
        local, sh = P.shard_params(params, P.unigen_specs(params, cfg, mesh), mesh)
        vs_local, vs_sh = P.shard_params(vs, P.siglip_specs(vs, mesh), mesh)
        state, m = step(TSFT.init_sft_state(local, tx, sh), vq, vs_local, batch, draws,
                        vision_sharding=vs_sh)
        out[case] = {"whole_metrics": _metrics(wm), "whole_params": whole.params,
                     "metrics": _metrics(m), "params": P.gather_params(state.params, sh),
                     "mode": step.mode}
    save(out_dir, name, out)


def dpo(inp, out_dir, name="dpo"):
    cfg, vq_cfg = inp["cfg"], inp["vq_cfg"]
    params, vq, batch, draws = inp["params"], inp["vq"], inp["batch"], inp["draws"]
    tx = TO.make_optimizer(params, 5e-4, _schedule(inp), max_grad_norm=1.0,
                           **inp.get("opt_kw", {}))
    step = TD.make_dpo_step(cfg, vq_cfg, tx, TD.DPOConfig(beta=0.1))
    whole, wm = step(TT.init_train_state(params, tx), params, vq, batch, draws)
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    specs = P.unigen_specs(params, cfg, mesh)
    local, sh = P.shard_params(params, specs, mesh)
    ref, _ = P.shard_params(params, specs, mesh)
    state, m = step(TT.init_train_state(local, tx, sharding=sh), ref, vq, batch, draws)
    save(out_dir, name, {"whole_metrics": _metrics(wm), "whole_params": whole.params,
                         "metrics": _metrics(m), "params": P.gather_params(state.params, sh)})


def vocab(inp, out_dir):
    """A Qwen2 tree of vocab 512 at model 2: the vocab-parallel embedding,
    text head and their gradients against the unsharded forward."""
    cfg, params, ids, labels = inp["qcfg"], inp["qparams"], inp["ids"], inp["labels"]
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    specs = P.sanitize_specs(P.partition_qwen2(params), params, mesh)
    out = {"specs": specs}
    for name, tree, sh in (("whole", params, None),
                           ("sharded", *P.shard_params(params, specs, mesh))):
        tree = W.map_tree(tree, lambda t: t.detach().clone().requires_grad_(True))
        specs = None if sh is None else sh.tree(tree)
        emb = qwen2.embed(tree, ids, specs)
        hidden, _ = qwen2.forward(tree, cfg, input_ids=ids, specs=specs)
        logits = qwen2.logits(tree, cfg, hidden, specs=specs)
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                 labels.reshape(-1))
        leaves = [t for _, t in TO.named_leaves(tree)]
        grads = torch.autograd.grad(loss, leaves)
        paths = [p for p, _ in TO.named_leaves(tree)]
        if sh is not None:
            grads = [PT.gather_full(g, sh.specs[p], mesh) for p, g in zip(paths, grads)]
        out[name] = {"embed": emb.detach(), "logits": logits.detach(), "loss": float(loss),
                     "grads": dict(zip(paths, grads))}
    save(out_dir, "vocab", out)


def ckpt(inp, out_dir):
    """The Trainer of the tiny PT2 config on (2, 2, 2) with add_fsdp: one
    step and its checkpoint; a Trainer on (4, 2, 1) resumes from it bit for
    bit and takes one more step. Rank 0 keeps the whole saved state for
    the one-process restore."""
    from unigen_tpu_torch.training.train import build_trainer, synthetic_flows
    from unigen_tpu_torch.utils.configuration import initialize_config
    run = os.path.join(out_dir, "run")

    def trainer(mesh, steps):
        config = initialize_config(inp["config"], inp["overrides"] + [
            f"experiment.output_dir={run}", f"training.max_train_steps={steps}"])
        return build_trainer(config, mesh=mesh, fsdp=True), config

    mesh_a = P.make_mesh(data=2, fsdp=2, model=2, device_type="cpu")
    tr_a, config = trainer(mesh_a, 1)
    state = tr_a.train(synthetic_flows(config))
    want = _whole_state(state)
    mesh_b = P.make_mesh(data=4, fsdp=2, model=1, device_type="cpu")
    tr_b, _ = trainer(mesh_b, 2)
    got = _whole_state(tr_b.state)
    q_b = tuple(tr_b.state.params["llm"]["layers"][0]["gate_w"].shape)
    resumed_at = tr_b.global_step
    state2 = tr_b.train(synthetic_flows(config))
    path = os.path.join(run, "checkpoint-1")
    save(out_dir, "ckpt", {"path": path, "want": want, "got": got, "resumed_at": resumed_at,
                           "step2": int(state2.step), "gate_local_b": q_b,
                           "whole_params": P.gather_params(state.params, state.sharding),
                           "files": sorted(os.listdir(os.path.join(path, "state"))),
                           "ranks_saved": sorted(os.listdir(os.path.join(run)))})


def t2i(inp, out_dir):
    """Tiny MaskGIT t2i at model 2: every rank's tokens equal the unsharded
    sampler's under the same seed."""
    from unigen_tpu_torch.generation import t2i_generate
    cfg, params, ids, uncond = inp["cfg"], inp["params"], inp["t2i_ids"], inp["t2i_uncond"]

    def run(tree, specs=None):
        g = torch.Generator().manual_seed(3)
        return t2i_generate(tree, cfg, g, ids, None, uncond_input_ids=uncond,
                            guidance_scale=3.0, timesteps=4, pad_id=0, specs=specs)

    whole = run(params)
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    local, sh = P.shard_params(params, P.unigen_specs(params, cfg, mesh), mesh)
    toks = run(local, sh.tree(local))
    everyone = MH.gather_objects(toks.tolist())
    save(out_dir, "t2i", {"whole": whole, "ranks": everyone})


def errors(inp, out_dir):
    out = {"mesh": _raises(lambda: P.make_mesh(data=-1, fsdp=3, device_type="cpu"), ValueError)}
    save(out_dir, "errors", out)


def _trees_equal(a, b) -> bool:
    la, lb = list(TO.named_leaves(a)), list(TO.named_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def quant(inp, out_dir):
    """W8A8 and W4A8 trees (JAX's quantization of the tiny models) and a tree
    with adapters at data 4 x model 2: the row-parallel products against one
    rank's; the W8A8 t2i codes; the W4A8 backbone's prefill and decode step
    (the down projection's groups straddle the rank's cut); and every tree
    gathered back from its shards at model 2, at model 4 (k/v whole) and on
    (2, 2, 2) with ``add_fsdp``."""
    from unigen_tpu_torch.generation import t2i_generate
    from unigen_tpu_torch.ops import int4 as T4
    from unigen_tpu_torch.ops import masks as TM
    from unigen_tpu_torch.ops import quantization as TQZ
    out = {}
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    r = C.model_index()

    def piece(x):
        k = x.shape[-1] // 2
        return x[..., r * k:(r + 1) * k]

    cfg, w8 = inp["cfg"], inp["w8"]
    local8, sh8 = P.shard_params(w8, P.unigen_specs(w8, cfg, mesh), mesh)
    cfg4, w4 = inp["cfg4"], inp["w4"]
    local4, sh4 = P.shard_params(w4, P.unigen_specs(w4, cfg4, mesh), mesh)
    rows = {}
    for name, x in inp["rows8"].items():
        lp, whole = local8["llm"]["layers"][0][name], w8["llm"]["layers"][0][name]
        rows[f"w8a8/{name}"] = bool(torch.equal(
            TQZ.dense_int8_row(lp, piece(x), C.max_over_model, C.sum_over_model),
            TQZ.dense_int8(whole, x)))
    for name, x in inp["rows4"].items():
        lp, whole = local4["llm"]["layers"][0][name], w4["llm"]["layers"][0][name]
        got = T4.dense_int4_row(lp, piece(x), C.max_over_model, C.sum_over_model)
        want = T4.dense_int4(whole, x)
        rows[f"w4a8/{name}"] = ((got - want).abs().max() / want.abs().max()).item()
    out["rows"] = MH.gather_objects(rows)
    out["groups4"] = sh4.groups

    # the tiny int8 t2i on the image head split over the codes
    t2i = inp["t2i"]
    mask = TM.create_attention_mask_predict_next(
        torch.cat([t2i["ids"], t2i["uncond"]]), t2i["pad"], t2i["soi"], t2i["eoi"],
        rm_pad_in_image=True)

    def codes(tree, combine, specs=None):
        return t2i_generate(tree, cfg, None, t2i["ids"], mask, uncond_input_ids=t2i["uncond"],
                            noise=t2i["noise"], pad_id=t2i["pad"], cfg_combine=combine,
                            specs=specs, **t2i["kw"])
    for combine in ("hidden", "logits"):
        out[f"t2i_{combine}"] = {"whole": codes(w8, combine), "ranks": MH.gather_objects(
            codes(local8, combine, sh8.tree(local8)).tolist())}

    # the W4A8 backbone: prefill into a cache of the rank's KV heads, one decode step
    bb = inp["backbone"]
    with torch.no_grad():
        for tag, tree, specs in (("whole", w4, None),
                                 ("sharded", local4, sh4.tree(local4)["llm"])):
            llm = tree["llm"]
            cache = qwen2.init_kv_cache(cfg4.llm, bb["ids"].shape[0], bb["total"], "cpu",
                                        num_kv_heads=qwen2.local_kv_heads(llm, cfg4.llm, specs))
            h, cache = qwen2.forward(llm, cfg4.llm, input_ids=bb["ids"],
                                     meta_bits=TM.pack_meta(TM.lm_attn_meta(bb["ids"], None)),
                                     cache=cache, specs=specs)
            h2, _ = qwen2.forward(llm, cfg4.llm, input_ids=bb["tok"], positions=bb["pos"],
                                  cache=cache, kv_rowmask=bb["valid"], specs=specs)
            out[f"backbone_{tag}"] = (h, h2, tuple(cache.k.shape))

    # the LoRA tree's gradients, every leaf's, at model 2 and at model 4 (k/v whole)
    lt, lcfg, ids, labels = inp["lora"], inp["lora_cfg"], inp["lora_ids"], inp["lora_labels"]

    def lora_grads(tree, sh):
        tree = W.map_tree(tree, lambda t: t.detach().clone().requires_grad_(True))
        specs = None if sh is None else sh.tree(tree)["llm"]
        h, _ = qwen2.forward(tree["llm"], lcfg.llm, input_ids=ids, specs=specs)
        lg = qwen2.logits(tree["llm"], lcfg.llm, h, specs=specs)
        loss = torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))
        paths, leaves = zip(*TO.named_leaves(tree["llm"]))
        grads = torch.autograd.grad(loss, leaves)
        if sh is not None:
            grads = [PT.gather_full(g, sh.specs[f"llm/{p}"], sh.mesh) for p, g in zip(paths, grads)]
        return dict(zip(paths, grads))
    whole = lora_grads(lt, None)
    out["lora_grads"] = {}
    for m in (2, 4):
        mesh = P.make_mesh(data=8 // m, fsdp=1, model=m, device_type="cpu")
        got = lora_grads(*P.shard_params(lt, P.unigen_specs(lt, lcfg, mesh), mesh))
        errs = {p: ((got[p] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                for p, g in whole.items()}
        out["lora_grads"][m] = MH.gather_objects(errs)

    # every tree back from its shards, bit for bit
    trips = {}
    for (d, f, m) in ((4, 1, 2), (2, 1, 4), (2, 2, 2)):
        mesh = P.make_mesh(data=d, fsdp=f, model=m, device_type="cpu")
        for name, (tree, c) in (("w8", (w8, cfg)), ("w4", (w4, cfg4)),
                                ("lora", (inp["lora"], inp["lora_cfg"]))):
            specs = P.unigen_specs(tree, c, mesh, fsdp=f > 1)
            local, sh = P.shard_params(tree, specs, mesh)
            trips[f"{name}@{d}x{f}x{m}"] = {
                "equal": _trees_equal(P.gather_params(local, sh), tree),
                "k": {p: s for p, s in specs.items() if re.search(r"layers/0/k(/|_)", p)},
                "fsdp": sum("fsdp" in s for s in specs.values())}
    out["roundtrip"] = MH.gather_objects(trips)
    save(out_dir, "quant", out)


def serving_quant(inp, out_dir):
    """The engine in int8+kv (W8A8, the int8 cache) and int8+int4 (W8A8
    admission, W4A8 decode chunks) at model 2 against the one-rank engine on
    the same requests: three greedy prompts and a sampled one. Every rank
    reports its tokens, decode chunks, busy steps and cache heads."""
    from unigen_tpu_torch.serving.engine import ServingEngine
    cfg, prompts = inp["cfg"], inp["prompts"]
    kw = dict(slots=2, max_len=48, buckets=(16,), chunk=(2, 4), device="cpu",
              keep_followed=True)

    def serve(tree, sharding=None, **extra):
        with ServingEngine(tree, cfg, sharding=sharding, **kw, **extra) as eng:
            heads = eng._cache.k.shape[3]
            if MH.process_index() and sharding is not None:
                eng.close(timeout=120)
                toks = [f.result(0) for _, f in sorted(eng.followed.items())]
            else:
                futs = [eng.submit(x, max_new_tokens=8) for x in prompts]
                futs.append(eng.submit(prompts[0], max_new_tokens=6, temperature=0.9, seed=5))
                toks = [f.result(60) for f in futs]
            return toks, eng.stats.decode_chunks, eng.stats.busy_steps, heads

    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    w8, w4 = inp["w8"], inp["w4"]
    l8, sh8 = P.shard_params(w8, P.unigen_specs(w8, cfg, mesh), mesh)
    l4, sh4 = P.shard_params(w4, P.unigen_specs(w4, cfg, mesh), mesh)
    out = {}
    for mode, (whole, sharded) in {
            "int8+kv": (dict(quantized_cache=True), dict(quantized_cache=True)),
            "int8+int4": (dict(decode_params=w4),
                          dict(decode_params=l4, decode_sharding=sh4))}.items():
        out[mode] = {"whole": serve(w8, **whole),
                     "ranks": MH.gather_objects(serve(l8, sh8, **sharded))}
    save(out_dir, "serving_quant", out)


def serving(inp, out_dir):
    """The serving engine at model 2 (rank 0 decides, the others follow its
    plan) against the one-rank engine on the same requests: three greedy
    prompts, a sampled one, and an embeddings prompt with speculation on;
    then a request rank 0 cancels after its first token; then two requests
    on an engine that keeps only the requests in flight. Every rank reports
    its tokens (a follower from ``followed``, kept), its stats, on a
    follower the error ``submit`` raises, and what the last engine's
    ``followed`` holds after its requests ended."""
    from concurrent.futures import CancelledError
    from unigen_tpu_torch.serving.engine import ServingEngine
    cfg, params, prompts = inp["cfg"], inp["params"], inp["prompts"]
    emb, bits, plen = inp["emb"], inp["bits"], inp["plen"]
    kw = dict(slots=2, max_len=48, buckets=(16,), chunk=(2, 4), speculate_k=2, device="cpu",
              keep_followed=True)

    def serve(tree, sharding=None):
        with ServingEngine(tree, cfg, sharding=sharding, **kw) as eng:
            if MH.process_index() and sharding is not None:
                err = _raises(lambda: eng.submit(prompts[0], max_new_tokens=2), RuntimeError)
                eng.close(timeout=120)
                assert not eng._thread.is_alive(), "a follower outlived rank 0's stop"
                return [f.result(0) for _, f in sorted(eng.followed.items())], eng.stats, err
            futs = [eng.submit(x, max_new_tokens=8) for x in prompts]
            futs.append(eng.submit(prompts[0], max_new_tokens=6, temperature=0.9, seed=5))
            futs.append(eng.submit_embeds(emb, bits, plen, max_new_tokens=7,
                                          lookup_ids=inp["emb_ids"]))
            return [f.result(60) for f in futs], eng.stats, ""

    def cancelled(tree, sharding):
        with ServingEngine(tree, cfg, sharding=sharding,
                           **dict(kw, speculate_k=0, chunk=2)) as eng:
            if MH.process_index():
                eng.close(timeout=120)
                assert not eng._thread.is_alive(), "a follower outlived rank 0's stop"
                fut = eng.followed[0]
            else:
                fut = eng.submit(prompts[1], max_new_tokens=30)
                next(fut.stream(60))
                fut.cancel()
            try:
                return fut.result(60)
            except CancelledError:
                return "cancelled"

    def pruned(tree, sharding):
        with ServingEngine(tree, cfg, sharding=sharding, **dict(kw, speculate_k=0, chunk=2,
                                                                keep_followed=False)) as eng:
            if MH.process_index():
                eng.close(timeout=120)
                assert not eng._thread.is_alive(), "a follower outlived rank 0's stop"
            else:
                for f in [eng.submit(x, max_new_tokens=3) for x in prompts[:2]]:
                    f.result(60)
            return sorted(eng.followed), eng.stats.requests_completed

    whole, whole_stats, _ = serve(params)
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    local, sh = P.shard_params(params, P.unigen_specs(params, cfg, mesh), mesh)
    toks, stats, err = serve(local, sh)
    out = {"toks": toks, "decode_chunks": stats.decode_chunks, "busy_steps": stats.busy_steps,
           "error": err, "cancel": cancelled(local, sh), "followed_after": pruned(local, sh)}
    save(out_dir, "serving", {"whole": whole, "whole_chunks": whole_stats.decode_chunks,
                              "ranks": MH.gather_objects(out)})


DERIVED = ("clone", "deepcopy", "save_load", "cast_roundtrip")


def derive(tree, how: str):
    """``tree`` rebuilt as new tensors with the same values, by one of the
    means that lose a tensor's identity: ``clone``, ``deepcopy``, a
    ``torch.save`` / ``torch.load`` round trip, or a cast to float64 and
    back (``requires_grad`` kept)."""
    if how == "deepcopy":
        return copy.deepcopy(tree)
    if how == "save_load":
        buf = io.BytesIO()
        torch.save(tree, buf)
        buf.seek(0)
        return torch.load(buf, weights_only=True)

    def cast(t):
        x = t.detach().double().to(t.dtype) if how == "cast_roundtrip" else t.detach().clone()
        return x.requires_grad_(t.requires_grad)
    return W.map_tree(tree, cast)


def derived(inp, out_dir):
    """Trees derived from shards (``derive``), run with their ``Sharding``:
    the tiny UniGen's logits at data 4 x model 2 and the PT2 step of a
    derived state's params on (2, 2, 2) with ``add_fsdp``, against the
    unsharded forward (the step's references are pt2's)."""
    cfg, vq_cfg, tcfg = inp["cfg"], inp["vq_cfg"], inp["tcfg"]
    params, vq, batch, draws, ids = (inp[k] for k in ("params", "vq", "batch", "draws", "ids"))
    out = {"logits": {}, "steps": {}}
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    local, sh = P.shard_params(params, P.unigen_specs(params, cfg, mesh), mesh)
    with torch.no_grad():
        out["whole_logits"] = TU.forward(params, cfg, input_ids=ids)
        for how in DERIVED:
            tree = derive(local, how)
            out["logits"][how] = TU.forward(tree, cfg, input_ids=ids, specs=sh.tree(tree))
    tx = TO.make_optimizer(params, 1e-3, _schedule(inp), max_grad_norm=1.0)
    step = TT.make_train_step(cfg, vq_cfg, tx, tcfg)
    mesh = P.make_mesh(data=2, fsdp=2, model=2, device_type="cpu")
    local, sh = P.shard_params(params, P.unigen_specs(params, cfg, mesh, fsdp=True), mesh)
    for how in DERIVED:
        state = TT.init_train_state(local, tx, sharding=sh)
        state, m = step(state._replace(params=derive(state.params, how)), vq, batch, draws)
        out["steps"][how] = {"metrics": _metrics(m), "params": P.gather_params(state.params, sh)}
    save(out_dir, "derived", out)


def without_specs(inp, out_dir):
    """The error of a sharded tree run without its specs: the tiny UniGen
    split in its attention (data 4 x model 2), split only in its MLP (the
    attention's specs dropped) and split on fsdp ((4, 2, 1) with
    ``add_fsdp``), and the SigLIP tower at model 2."""
    cfg, params, ids = inp["cfg"], inp["params"], inp["ids"]
    attention = re.compile(r"layers/\d+/[qkvo]_[wb]$")
    trees = {}
    mesh = P.make_mesh(data=4, fsdp=1, model=2, device_type="cpu")
    specs = P.unigen_specs(params, cfg, mesh)
    trees["attention"] = P.shard_params(params, specs, mesh)[0]
    mlp = {p: (None,) * len(s) if attention.search(p) else s for p, s in specs.items()}
    trees["mlp"] = P.shard_params(params, mlp, mesh)[0]
    vs = inp["vs"]
    tower = P.shard_params(vs, P.siglip_specs(vs, mesh), mesh)[0]
    mesh = P.make_mesh(data=4, fsdp=2, model=1, device_type="cpu")
    trees["fsdp"] = P.shard_params(params, P.unigen_specs(params, cfg, mesh, fsdp=True),
                                   mesh)[0]
    out = {name: _raises(lambda t=t: TU.forward(t, cfg, input_ids=ids), ValueError)
           for name, t in trees.items()}
    pixels = torch.zeros((1, inp["vs_cfg"].image_size, inp["vs_cfg"].image_size, 3))
    out["siglip"] = _raises(lambda: TSG.forward(tower, inp["vs_cfg"], pixels), ValueError)
    save(out_dir, "without_specs", out)


PROGRAMS = ("pt2", "sft", "dpo", "vocab", "ckpt", "t2i", "errors", "serving", "quant",
            "serving_quant", "sft_lora", "dpo_lora", "derived", "without_specs")


def parallel_all(inp, out_dir):
    for program in PROGRAMS:
        if program.endswith("_lora"):
            globals()[program[:-len("_lora")]](inp[program], out_dir, program)
        else:
            globals()[program](inp[program], out_dir)


def multihost(inp, out_dir):
    """tests/test_multihost.py's checks at the world's size, then the CoT
    rating table of the world's ranks."""
    rank, n = MH.process_index(), MH.process_count()
    out = {"rank": rank, "count": n}
    out["gather"] = MH.gather_objects({"rank": rank, "rows": [rank * 10, rank * 10 + 1]})
    out["ragged"] = MH.gather_objects(["x"] * (rank % 3 + 1))
    out["bcast0"] = MH.broadcast_object({"cfg": [1, 2, 3]} if rank == 0 else None)
    out["bcast_last"] = MH.broadcast_object(f"from {rank}" if rank == n - 1 else None,
                                            source=n - 1)
    MH.sync_hosts()
    if inp is not None:
        from unigen_tpu_torch.evaluation.cot import run_cot
        out["cot"] = run_cot(inp["pipeline"], inp["prompts"], **inp["kw"])
    everyone = MH.gather_objects({k: v for k, v in out.items() if k != "cot"})
    save(out_dir, "multihost", {"ranks": everyone, "cot": out.get("cot")})
