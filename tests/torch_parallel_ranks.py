"""The rank side of the port's parallel CPU tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_generate.py``).

Each test file spawns one world of 4 gloo ranks on the CPU
(``parallel.launch.run_world``) that runs ``run_cases`` on the file's case
list; every rank returns {case name: result}.  This module imports the
port and torch only (a spawned rank imports it by name), never JAX: the
test files compute the JAX package's references in the parent.

A case is a dict with ``name``, ``kind`` (a function of ``KINDS``) and its
arguments; a model case carries ``model`` = (zoo name, build kwargs,
QuantConfig kwargs) and ``state`` (``carry.export_state`` of the model the
parent built, converted or not), which every rank installs with
``carry.load_jax_state``.  A case that raises returns {"error": message},
which its test reports.
"""

import numpy as np
import torch

import int8inferenceengine_tpu_torch as qt
from int8inferenceengine_tpu_torch.carry import load_jax_state
from int8inferenceengine_tpu_torch.models import zoo
from int8inferenceengine_tpu_torch.ops import gemm_int8 as G
from int8inferenceengine_tpu_torch.parallel import make_mesh
from int8inferenceengine_tpu_torch.parallel import overlap as OV

FLAGS = ("_tp_sharded", "_tp_local", "_tp_row", "_tp_expert")


def build(spec, state=None, device="cpu"):
    """The case's model on ``device``, with ``state`` installed."""
    name, kw, cfg = spec
    m = zoo.build(name, config=qt.QuantConfig(**cfg), device=device, **kw)
    if state is not None:
        load_jax_state(m, state)
    return m


def mesh_key(shape, overlap=False) -> str:
    return f"{shape[0]}x{shape[1]}" + ("_overlap" if overlap else "")


def flags_of(m, names) -> dict:
    layers = dict(m.named_layers())
    return {n: [bool(getattr(layers[n], f)) for f in FLAGS] for n in names}


def _input(m, x, quantized):
    if not quantized:
        return qt.tensor(x, device=m.device)
    cfg = m.config
    (batch,) = list(qt.DataLoader(
        x, x.shape[0], quantize_to=(cfg.input_scale, cfg.input_zero_point),
        device=m.device))
    return batch


def forward(case):
    """The unsharded forward, then ``shard()`` on each of ``meshes``
    ((shape, overlap) pairs) and the sharded forward; the role flags of
    ``flags`` and the ring / row-parallel products of each."""
    device = case.get("device", "cpu")
    m = build(case["model"], case["state"], device)
    x = case["x"]
    quantized = case.get("quantized_input", False)
    out = {"base": m(_input(m, x, False)).numpy(), "out": {}, "flags": {},
           "ring": {}, "row": {}}
    for shape, overlap in case["meshes"]:
        key = mesh_key(shape, overlap)
        m.shard(make_mesh(shape, devices="cpu" if device == "cpu" else None),
                overlap=overlap)
        out["flags"][key] = flags_of(m, case.get("flags", ()))
        OV.ring_qgemm.calls = G.qgemm_row_parallel.calls = 0
        out["out"][key] = m(_input(m, x, quantized)).numpy()
        out["ring"][key] = OV.ring_qgemm.calls
        out["row"][key] = G.qgemm_row_parallel.calls
        if quantized:
            out["out"][key + "_float"] = m(_input(m, x, False)).numpy()
    return out


def generate(case):
    """Greedy ``generate(ids, steps)`` unsharded and on each mesh, and on
    each mesh a sampled run made twice."""
    m = build(case["model"], case["state"])
    ids, steps = case["ids"], case["steps"]
    out = {"base": m.generate(ids, steps), "out": {}, "sampled": {},
           "flags": {}}
    for shape in case["meshes"]:
        key = mesh_key(shape)
        m.shard(make_mesh(shape, devices="cpu"))
        out["flags"][key] = flags_of(m, case.get("flags", ()))
        out["out"][key] = m.generate(ids, steps)
        out["sampled"][key] = [m.generate(ids, 6, temperature=0.8, top_k=20,
                                          seed=7) for _ in range(2)]
    return out


def shard_before_convert(case):
    """``shard()`` on the FP32 model, then prepare, calibrate and convert:
    the model stays sharded (its quantized slices bound) and its codes
    equal the unsharded conversion's."""
    m = build(case["model"], case["state"])
    m.shard(make_mesh(case["mesh"], devices="cpu"))
    m.prepare()
    m(qt.tensor(case["calib"], device="cpu"))
    m.convert()
    return {"sharded": m._mesh is not None,
            "conv1_slices": sorted(m.conv1._tp_view),
            "out": m(qt.tensor(case["x"], device="cpu")).numpy()}


def load_after_shard(case):
    """``shard()`` and a sharded forward, then new weights written over
    the model by ``Module.load`` (FP32), ``utils.load`` and
    ``load_state_dict`` (INT8); the same write to an unsharded copy.
    Each writer's sharded forward before and after, and the copy's."""
    import os
    import tempfile
    from int8inferenceengine_tpu_torch import utils
    x = qt.tensor(case["x"], device="cpu")
    new = build(case["model"], case["new_state"])
    d = tempfile.mkdtemp()
    path = os.path.join(d, "new.npz")
    utils.save(new, path)
    writers = {"module_load": (case["fp32_state"],
                               lambda m: m.load(case["new_sd"])),
               "utils_load": (case["state"], lambda m: utils.load(m, path)),
               "load_state_dict": (case["state"], lambda m: m.load_state_dict(
                   new.state_dict()))}
    out = {}
    try:
        for name, (state, write) in writers.items():
            m = build(case["model"], state)
            m.shard(make_mesh(case["mesh"], devices="cpu"))
            before = m(x).numpy()
            write(m)
            whole = build(case["model"], state)
            write(whole)
            out[name] = {"before": before, "after": m(x).numpy(),
                         "unsharded": whole(x).numpy()}
    finally:
        os.remove(path)
        os.rmdir(d)
    return out


def raises(case):
    """The message of the error that ``case['what']`` raises."""
    try:
        if case["what"] == "mesh":
            make_mesh(case["shape"], devices="cpu")
        elif case["what"] == "batch":
            m = build(case["model"], case["state"])
            m.shard(make_mesh(case["shape"], devices="cpu"))
            m(qt.tensor(case["x"], device="cpu"))
        elif case["what"] == "tap":
            # an input-tap lever's pass (AdaRound, GPTQ) reaching a
            # row-parallel Linear in an active TP context
            from int8inferenceengine_tpu_torch.parallel.sharding import \
                sharded
            from int8inferenceengine_tpu_torch.utils.tap import \
                tapped_forward
            m = build(case["model"], case["state"])
            m.shard(make_mesh(case["shape"], devices="cpu"))
            with sharded(m):
                tapped_forward(m, case["x"])
        elif case["what"] == "bias_correction":
            # a row-parallel Linear preparing under bias_correction in an
            # active TP context
            from int8inferenceengine_tpu_torch.parallel.sharding import \
                sharded
            m = build(case["model"], case["state"])
            m.shard(make_mesh(case["shape"], devices="cpu"))
            m.prepare()
            layer = dict(m.named_layers())[case["layer"]]
            with sharded(m):
                layer(qt.tensor(case["x"], device="cpu"))
        elif case["what"] == "speculative":
            m = build(case["model"], case["state"])
            m.shard(make_mesh(case["shape"], devices="cpu"))
            m.generate_speculative(m, case["x"], 4, k=2)
        else:
            raise KeyError(case["what"])
    except Exception as e:                   # the result this case reads
        return {"type": type(e).__name__, "message": str(e)}
    return {"type": None, "message": ""}


def ring(case):
    """``ring_qgemm`` on each rank's chunk and local columns of a model
    axis of ``p`` (mesh (4 / p, p)), its output columns gathered over the
    model group; and ``ring_linear_reference`` on the whole operands."""
    from int8inferenceengine_tpu_torch.parallel.sharding import (
        all_gather_cat, sharded)
    p, kw = case["p"], case["kw"]
    a, w_nk, oc, ep = (torch.from_numpy(case[k]) for k in
                       ("a", "w_nk", "oc", "ep"))
    mesh = make_mesh((4 // p, p), devices="cpu")
    i = mesh.coords["model"]
    kc, nc = a.shape[1] // p, w_nk.shape[0] // p
    m = zoo.build("fc_mnist", device="cpu")      # any module holds the mesh
    m.shard(mesh)
    with sharded(m) as pa:
        got = OV.ring_qgemm(
            a[:, i * kc:(i + 1) * kc].contiguous(),
            w_nk[i * nc:(i + 1) * nc].contiguous(),
            oc[i * nc:(i + 1) * nc], ep[i * nc:(i + 1) * nc], pa=pa, **kw)
        got = all_gather_cat(got, pa.model_group, 1)
    want = OV.ring_linear_reference(a, w_nk, oc, ep, **kw)
    return {"got": got.numpy(), "reference": want.numpy()}


def _submit_all(eng, case):
    """``case['prefixes']`` registered, then every request of ``case``
    submitted at once (``prefix`` = i names the i-th registered prefix);
    (their tokens, the prefix ids)."""
    pids = [eng.register_prefix(p) for p in case.get("prefixes", ())]
    futs = []
    for r in case["requests"]:
        kw = dict(r.get("kw", {}))
        if "prefix" in kw:
            kw["prefix_id"] = pids[kw.pop("prefix")]
        futs.append(eng.submit(r["prompt"], r["n"], **kw))
    return [f.result(timeout=120) for f in futs], pids


def engine(case):
    """``GenerationEngine`` over the model ``shard()``ed on ``mesh``: every
    rank builds it, rank 0 registers ``prefixes`` (if any), submits every
    request at once, reads the tokens and drops the prefixes, a
    follower's ``submit()`` must raise, and every rank shuts it down.
    Beside it: the unsharded ``generate()`` of each greedy request and,
    with ``unsharded_engine``, the same requests through the unsharded
    engine (``_oracle``); with ``sharded_generate`` their sharded
    ``generate()`` (``_batched_generate``)."""
    import torch.distributed as dist
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    reqs = case["requests"]
    greedy = [not r.get("kw", {}).get("temperature") for r in reqs]
    kw = case["engine"]

    def unsharded(m):
        got = {"base": _batched_generate(
            m, [r["prompt"] if g else None for r, g in zip(reqs, greedy)],
            [r["n"] for r in reqs], 1)}
        if case.get("unsharded_engine"):
            eng = GenerationEngine(m, **kw)
            try:
                got["unsharded_engine"] = _submit_all(eng, case)[0]
            finally:
                eng.shutdown()
        return got

    out = _oracle(case, unsharded)
    m = build(case["model"], case["state"])
    mesh = make_mesh(case["mesh"], devices="cpu")
    m.shard(mesh)
    if case.get("sharded_generate"):
        out["sharded_generate"] = _batched_generate(
            m, [r["prompt"] if g else None for r, g in zip(reqs, greedy)],
            [r["n"] for r in reqs], mesh.shape["data"])
    eng = GenerationEngine(m, **kw)
    out["kv_sharded"] = eng._kv_sharded
    out["cache_channels"] = int(eng._kv_channels)
    try:
        if dist.get_rank() == 0:
            tokens, pids = _submit_all(eng, case)
            got = {"out": tokens, "pids": pids}
            for pid in pids:
                eng.unregister_prefix(pid)
            got["stats"] = {"requests": eng.stats.requests,
                            "prefix_hits": eng.stats.prefix_hits,
                            "chunks": eng.stats.chunks}
        else:
            try:
                eng.submit(reqs[0]["prompt"], 2)
                got = "a follower's submit() did not raise"
            except RuntimeError as e:
                got = str(e)
    finally:
        eng.shutdown()
    # rank 0's tokens and rank 1's refusal on every rank, so that every
    # rank returns the same
    out.update(_from_rank0(got if dist.get_rank() == 0 else None))
    out["follower"] = _from_rank0(got if dist.get_rank() == 1 else None, 1)
    return out


def _batched_generate(m, prompts, ns, rows_multiple):
    """Each prompt's ``generate()`` tokens (None for a None prompt): one
    call a prompt length, its distinct prompts as the rows of one batch
    (rows are independent), padded to a multiple of ``rows_multiple``."""
    out = [None] * len(prompts)
    for t in sorted({len(p) for p in prompts if p is not None}):
        idx = [i for i, p in enumerate(prompts)
               if p is not None and len(p) == t]
        rows = []
        for i in idx:
            if not any(np.array_equal(prompts[i], r) for r in rows):
                rows.append(prompts[i])
        rows += rows[:1] * (-len(rows) % rows_multiple)
        toks = m.generate(np.stack(rows), max(ns[i] for i in idx))
        for i in idx:
            j = next(j for j, r in enumerate(rows)
                     if np.array_equal(prompts[i], r))
            out[i] = toks[j, :ns[i]]
    return out


def _from_rank0(value, src=0):
    """``value`` of rank ``src`` on every rank."""
    import torch.distributed as dist
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _oracle(case, fn):
    """``fn`` of the case's unsharded model, computed once, on one rank (a
    model of its own, so that every rank's sharded model has the same
    history), and returned on every rank."""
    import zlib
    import torch.distributed as dist
    src = zlib.crc32(case["name"].encode()) % dist.get_world_size()
    return _from_rank0(fn(build(case["model"], case["state"]))
                       if dist.get_rank() == src else None, src)


def engine_guards(case):
    """The sharded engine's refusals: slots that do not divide the data
    axis; a weight-only model; and a prefix registration, which
    composes."""
    import torch.distributed as dist
    from int8inferenceengine_tpu_torch.serve import GenerationEngine
    out = {"slots": None, "weight_only": None}
    m = build(case["model"], case["state"])
    m.shard(make_mesh(case["mesh"], devices="cpu"))
    try:
        GenerationEngine(m, slots=case["bad_slots"])
    except ValueError:
        out["slots"] = "ValueError"
    eng = GenerationEngine(m, slots=4, prefill_chunk=8)
    try:
        pid = eng.register_prefix([1, 2, 3]) if dist.get_rank() == 0 \
            else None
    finally:
        eng.shutdown()
    out["pid"] = _from_rank0(pid)
    wo = build(case["weight_only_model"], case["weight_only_state"])
    wo.shard(make_mesh(case["mesh"], devices="cpu"))
    try:
        GenerationEngine(wo, slots=4)
    except NotImplementedError:
        out["weight_only"] = "NotImplementedError"
    return out


def speculative(case):
    """Greedy ``generate()`` and ``generate_speculative`` with the
    replicated ``draft`` unsharded, then with the target ``shard()``ed on
    ``mesh``; the guards (a sharded draft, a batch that does not divide
    the data axis)."""
    ids, steps, k = case["ids"], case["steps"], case["k"]
    out = _oracle(case, lambda t: {
        "base": t.generate(ids, steps),
        "spec_base": t.generate_speculative(
            build(case["draft"], case["draft_state"]), ids, steps, k=k)})
    t = build(case["model"], case["state"])
    d = build(case["draft"], case["draft_state"])
    mesh = make_mesh(case["mesh"], devices="cpu")
    t.shard(mesh)
    out["sharded"] = t.generate(ids, steps)
    out["spec"] = t.generate_speculative(d, ids, steps, k=k)
    out["stats"] = t.speculative_stats
    guards = {}
    try:
        t.generate_speculative(d, ids[:3], steps, k=k)
    except ValueError:
        guards["batch"] = "ValueError"
    d.shard(mesh)
    try:
        t.generate_speculative(d, ids, steps, k=k)
    except NotImplementedError:
        guards["sharded_draft"] = "NotImplementedError"
    out["guards"] = guards
    return out


def inference_engine(case):
    """``InferenceEngine`` over LeNet ``shard()``ed on ``mesh``: rank 0
    submits a request the model refuses (3 channels) and then ``x``;
    the unsharded forward beside it."""
    import torch.distributed as dist
    from int8inferenceengine_tpu_torch.serve import InferenceEngine
    x = case["x"]
    out = _oracle(case, lambda m: {
        "base": m(qt.tensor(x, device="cpu")).numpy()})
    m = build(case["model"], case["state"])
    m.shard(make_mesh(case["mesh"], devices="cpu"))
    eng = InferenceEngine(m, max_batch=32)
    got = None
    try:
        if dist.get_rank() == 0:
            bad = eng.submit(case["bad"])
            good = eng.submit(x)
            got = {"out": good.result(timeout=120),
                   "small": eng.infer(x[:4])}
            try:
                bad.result(timeout=120)
                got["bad"] = None
            except Exception as e:
                got["bad"] = type(e).__name__
    finally:
        eng.shutdown()
    out.update(_from_rank0(got))
    out["follower_failure"] = _follower_failure(m, x[:4])
    return out


def _follower_failure(m, x):
    """A tile that fails on rank 1 alone (after its forward, so that no
    collective is left open): rank 0 serves it, and rank 1's engine raises
    at the next record, which its ``shutdown()`` reports.  (rank 0's
    reply, rank 1's error) on every rank."""
    import torch.distributed as dist
    from int8inferenceengine_tpu_torch.serve import InferenceEngine
    forward = InferenceEngine._forward

    def failing(self, batch):
        forward(self, batch)
        raise MemoryError("rank 1 alone")
    if dist.get_rank() == 1:      # before the engine's thread can run
        InferenceEngine._forward = failing
    try:
        eng = InferenceEngine(m, max_batch=32)
        reply = eng.infer(x).shape if dist.get_rank() == 0 else None
        try:
            eng.shutdown()
            err = None
        except RuntimeError as e:
            err = str(e)
    finally:
        InferenceEngine._forward = forward
    return _from_rank0(reply), _from_rank0(err, 1)


KINDS = {"forward": forward, "generate": generate,
         "engine": engine, "engine_guards": engine_guards,
         "speculative": speculative, "inference_engine": inference_engine,
         "shard_before_convert": shard_before_convert,
         "load_after_shard": load_after_shard, "raises": raises,
         "ring": ring}


def run_cases(cases) -> dict:
    """Every case of the file on this rank: {name: result}."""
    out = {}
    for case in cases:
        try:
            out[case["name"]] = KINDS[case["kind"]](case)
        except Exception as e:               # reported by the case's test
            import traceback
            out[case["name"]] = {"error": f"{type(e).__name__}: {e}\n"
                                          + traceback.format_exc()[-2000:]}
    return out
