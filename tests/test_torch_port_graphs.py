"""The serving engine's piecewise route (engine/graphs.py) against its eager
route, bit for bit.

On the CPU the route's pieces run as plain calls (`InferenceEngine(...,
graphs=True)`), so these tests hold everything around them: the blocks cut
at their bank attention (models/stages.py), the static tensors each piece
reads and writes, the eager bank attention between the stages, the label
piece's input labels, the memory piece's in-place bank write and its
static write flag, the ConvGRU memory's eager rounds, the schedule. The
tests marked `card` capture and replay CUDA graphs at the benchmark's
shapes and skip without a CUDA device; this file imports no JAX, so that
they run on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_port_graphs.py
"""

import numpy as np
import pytest
import torch

from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.engine.graphs import capture_stream
from rmem_tpu_torch.engine.inference import separate_mask
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.models.stages import BankQuery, run_stages
from rmem_tpu_torch.ops.resize import resize_nearest

BANK = ("k", "v", "count", "score", "scored", "times", "order")
RAW_HW = (97, 129)
# two augs, one flipped and at another size; 12 objects: two id groups
AUGS = [((97, 129), False), ((65, 97), True)]
OBJECTS = 12
# former 1 + latter 2 slots and a write every 2 frames: the bank is full
# after frame 4, and every later write evicts
OVER = dict(compute_dtype="float32", former_mem_len=1, latter_mem_len=2)
GAP = 2
FRAMES, CHUNK = 9, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread, as in the other port files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _engine(model, graphs, device="cpu", seed=0, **over):
    cfg = get_config("pre_vost", model=model, **over)
    net = init_params(build_vos_model(cfg.model_vos, cfg), seed=seed)
    return InferenceEngine(net, cfg, device=device, graphs=graphs)


def _video(frames, raw_hw, objects, seed=3):
    """Seeded raw uint8 frames [T, H, W, 3] and a first mask of `objects`
    vertical stripes."""
    rng = np.random.RandomState(seed)
    raw = torch.from_numpy((rng.rand(frames + 1, *raw_hw, 3) * 255).astype(
        np.uint8))
    mask = torch.zeros(raw_hw, dtype=torch.int32)
    width = raw_hw[1] // (objects + 1)
    for i in range(objects):
        mask[raw_hw[0] // 10:-raw_hw[0] // 10,
             width * i + 2:width * (i + 1)] = i + 1
    return raw, mask


def _references(eng, raw0, mask, augs, gap):
    """Each aug's state after the first frame, as the evaluator makes
    them: the frame prepared on the device, the mask flipped at full size,
    nearest-resized and split into the id groups."""
    m = eng.cfg.model_max_obj_num
    objects = int(mask.max())
    groups = -(-objects // m)
    obj_nums = [min(m, objects - g * m) for g in range(groups)]
    mask = mask.to(eng.device)
    states = []
    for in_hw, flip in augs:
        lab = resize_nearest((mask.flip(1) if flip else mask)[None, ..., None],
                             in_hw)[..., 0]
        st, _ = eng.add_reference(eng.prep(raw0[None], in_hw, flip)[0],
                                  separate_mask(lab, groups, m), obj_nums,
                                  gap=gap)
        states.append(st)
    return states


def _serve(eng, raw, mask, augs, multi, chunk=CHUNK, gap=GAP):
    """Serve frames 1.. of `raw` in chunks; after each chunk, the labels
    and a copy of every aug's bank and short-term memory."""
    states = _references(eng, raw[0], mask, augs, gap)
    in_hws, flips = [a[0] for a in augs], [a[1] for a in augs]
    out_hw = tuple(raw.shape[1:3])
    chunks = []
    for t in range(1, raw.shape[0], chunk):
        part = raw[t:t + chunk]
        if multi:
            states, labels = eng.scan_steps_multi_raw(states, part, in_hws,
                                                      out_hw, flips)
        else:
            st, labels = eng.scan_steps_raw(states[0], part, in_hws[0],
                                            out_hw, flips[0])
            states = [st]
        chunks.append((labels.clone(), [
            {**{f: getattr(st.bank, f).clone() for f in BANK},
             "short_k": st.short_k.clone(), "short_v": st.short_v.clone(),
             "schedule": (st.frame_step, st.last_mem_step, st.long_writes)}
            for st in states]))
    return chunks, states


def _assert_same(got, want):
    for (labels, augs), (labels_w, augs_w) in zip(got, want, strict=True):
        assert torch.equal(labels, labels_w)
        for a, w in zip(augs, augs_w, strict=True):
            for name, x in a.items():
                if name == "schedule":
                    assert x == w[name]
                else:
                    assert torch.equal(x, w[name]), name


CASES = [("tiny_aotl", {}), ("tiny_deaotl", {}),
         ("tiny_aotl", {"gru_memory": True}),
         ("tiny_aotl", {"no_long_memory": True}),
         ("tiny_deaotl", {"use_pallas_dwconv": True, "qminor": True})]


@pytest.mark.parametrize("multi", [True, False], ids=["step_multi", "step"])
@pytest.mark.parametrize("model,over", CASES,
                         ids=["aotl", "deaotl", "aotl_gru", "aotl_no_long",
                              "deaotl_optins"])
def test_piecewise_route_matches_eager_route(model, over, multi,
                                             monkeypatch):
    """Every chunk's labels, banks, short-term memories and write schedules
    of the piecewise route equal the eager route's, through the bank's
    filling and its evictions (or the ConvGRU memory's rounds). The first
    frame of each state is served eagerly, the second captures the pieces,
    every later one replays them."""
    over = dict(over)
    if over.pop("qminor", False):
        monkeypatch.setenv("RMEM_BANK_QMINOR", "1")   # read when built
    augs = AUGS if multi else AUGS[:1]
    objects = OBJECTS if multi else 3
    raw, mask = _video(FRAMES, RAW_HW, objects)
    runs = {}
    for graphs in (False, True):
        eng = _engine(model, graphs, **OVER, **over)
        runs[graphs] = _serve(eng, raw, mask, augs, multi)[0], eng
    _assert_same(runs[True][0], runs[False][0])
    eager, pieces = runs[False][1], runs[True][1]
    layers = pieces.cfg.model_lstt_num
    per_frame = len(augs) * (layers + 4) + 1
    assert (eager.graph_captures, eager.graph_replays,
            eager.eager_frames) == (0, 0, FRAMES)
    assert (pieces.graph_captures, pieces.graph_replays,
            pieces.eager_frames) == (per_frame, per_frame * (FRAMES - 2), 1)


def test_engine_on_the_cpu_serves_eagerly_by_default():
    eng = _engine("tiny_aotl", None, **OVER)
    raw, mask = _video(3, RAW_HW, 3)
    _, states = _serve(eng, raw, mask, AUGS[:1], multi=False)
    assert not eng.graphs and states[0].graphs is None
    assert (eng.graph_captures, eng.eager_frames) == (0, 3)


def test_write_flag_follows_the_schedule():
    """Frame by frame, the memory piece's static write flag is what the
    host's schedule decides (a write every GAP frames), the bank's count
    grows by the writes until it is full, and every write after that
    evicts: the count stays and the written slot takes the newest rank."""
    eng = _engine("tiny_aotl", True, **OVER)
    raw, mask = _video(12, RAW_HW, 3)
    st = _references(eng, raw[0], mask, AUGS[:1], GAP)[0]
    imgs = eng.prep(raw[1:], AUGS[0][0])
    slots = OVER["former_mem_len"] + OVER["latter_mem_len"]
    for t, img in enumerate(imgs, start=1):
        writes = st.long_writes
        st, _ = eng.step(st, img, RAW_HW)
        due = t % GAP == 0
        assert st.long_writes == writes + due
        assert int(st.bank.count) == min(slots, 1 + t // GAP)
        if st.graphs is not None and "memory" in st.graphs.pieces:
            assert bool(st.graphs.flag) == due
            if due and 1 + t // GAP > slots:
                newest = int(torch.argmax(torch.where(
                    torch.arange(slots + 1) < slots, st.bank.order, -1)))
                assert int(st.bank.times[newest]) == 1
    assert st.graphs is not None and eng.graph_replays > 0


def test_state_keeps_its_tensors_and_direct_calls_replay():
    """After the capture a state's bank and short-term memory keep their
    storage frame after frame, and `propagate` + `write_label` called on
    it directly (the evaluator's per-frame path) replay its pieces and
    give what the eager route gives for the same calls."""
    raw, mask = _video(6, RAW_HW, OBJECTS)
    out = {}
    for graphs in (False, True):
        eng = _engine("tiny_deaotl", graphs, **OVER)
        states = _references(eng, raw[0], mask, AUGS, GAP)
        in_hws, flips = [a[0] for a in AUGS], [a[1] for a in AUGS]
        states, _ = eng.scan_steps_multi_raw(states, raw[1:3], in_hws,
                                             RAW_HW, flips)
        ptrs = [(st.bank.k.data_ptr(), st.bank.count.data_ptr(),
                 st.bank.order.data_ptr(), st.short_k.data_ptr())
                for st in states]
        replays = eng.graph_replays
        labels = []
        for t in range(3, 6):
            with torch.inference_mode():
                for st, (hw, flip) in zip(states, AUGS):
                    _, logits4 = eng.propagate(st, eng.prep(
                        raw[t:t + 1], hw, flip)[0])
                    labels.append(logits4.clone())
                # a label from outside the engine's pieces
                label = raw[t, ..., 0].to(torch.int64) % (OBJECTS + 1)
                for st, (hw, flip) in zip(states, AUGS):
                    eng.write_label(st, label, hw, flip)
        out[graphs] = (labels, [{f: getattr(st.bank, f).clone()
                                 for f in BANK} for st in states])
        if graphs:
            assert ptrs == [(st.bank.k.data_ptr(), st.bank.count.data_ptr(),
                             st.bank.order.data_ptr(), st.short_k.data_ptr())
                            for st in states]
            # 3 frames x 2 augs x (encode, 3 stages, decode, memory)
            assert eng.graph_replays - replays == 3 * 2 * 6
    for a, b in zip(out[True][0], out[False][0]):
        assert torch.equal(a, b)
    for a, b in zip(out[True][1], out[False][1]):
        for f in BANK:
            assert torch.equal(a[f], b[f]), f


@pytest.mark.parametrize("model", ["tiny_aotl", "tiny_deaotl"])
def test_stages_yield_each_block_and_compose_the_forward(model):
    """A stack driven stage by stage, each query answered by its own
    bank attention, gives the forward's outputs; it yields one query a
    block, each a BankQuery of the eval route."""
    eng = _engine(model, False, **OVER)
    stack = eng.model.lstt
    raw, mask = _video(1, RAW_HW, 3)
    st = _references(eng, raw[0], mask, AUGS[:1], GAP)[0]
    with torch.inference_mode():
        xs, feat, size_2d = eng._encode(eng.prep(raw[1:2], AUGS[0][0])[0],
                                        1)
        args = (feat, (st.bank.k, st.bank.v), st.bank.count,
                (st.short_k, st.short_v), None,
                *eng._temporal_pes(st.bank), size_2d)
        kw = dict(self_pos=eng.model.get_pos_emb(*size_2d))
        want = stack(*args, **kw)
        stages, queries = stack.stages(*args, **kw), []
        try:
            query = next(stages)
            while True:
                queries.append(query)
                query = stages.send(query.attend())
        except StopIteration as done:
            got = done.value
        assert run_stages(stack.stages(*args, **kw))[2] is not None
    assert len(queries) == stack.num_layers
    assert all(isinstance(q, BankQuery) and q.route == "infer"
               for q in queries)
    for g, w in zip(got[0], want[0], strict=True):
        assert torch.equal(g, w)
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k])
    assert torch.equal(got[2], want[2])


def test_a_capture_tallies_its_own_thread_launches_only():
    """Inside `tallied()` a wrapper's launch on the capturing thread goes
    to the tally and not to its counter; one on another thread (the
    evaluator's decoder during a capture) goes to the counter."""
    import threading

    from rmem_tpu_torch.kernels.launches import launched, tallied

    def wrapper():
        wrapper.launches += launched(wrapper)

    wrapper.launches = 0
    with tallied() as tally:
        wrapper()
        wrapper()
        other = threading.Thread(target=wrapper)
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert tally == {wrapper: 2} and wrapper.launches == 1
    wrapper()
    assert wrapper.launches == 2


# ---- on the card ---------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _counts():
    from rmem_tpu_torch.kernels import bank_attention as kb
    from rmem_tpu_torch.kernels import local_attention as kl
    from rmem_tpu_torch.kernels import stem as ks
    return {f.__name__: f.launches for f in (
        kb.bank_attention_infer, kb.bank_attention_infer_mh,
        kb.bank_attention_qminor, kl.local_attention, ks.stem)}


# the benchmark's serving cell: 480 x 854 frames at scales 1.0 and 1.3,
# each plain and flipped, 12 objects in two id groups
CELL_RAW_HW = (480, 854)
CELL_AUGS = [((481, 849), False), ((481, 849), True), ((625, 1105), False),
             ((625, 1105), True)]


@pytest.mark.card
@pytest.mark.parametrize("model,augs,objects", [
    ("r50_aotl", CELL_AUGS, OBJECTS), ("r50_deaotl", CELL_AUGS[:1], 10)],
    ids=["r50_aotl_4augs", "r50_deaotl_1aug"])
def test_replay_matches_eager_on_the_card(card, model, augs, objects):
    """The CUDA graphs against the eager route on the same weights and
    frames, bf16 as served: labels, every aug's bank (keys, values, slot
    order, scores) and short-term memory after every chunk, bit for bit,
    the bank filled and evicting (a write every 2 frames into 1 + 8
    slots); the kernel wrappers' launch counts equal; the engine's
    counters."""
    multi = len(augs) > 1
    raw, mask = _video(26, CELL_RAW_HW, objects)
    raw = raw.pin_memory()
    runs = {}
    for graphs in (False, True):
        eng = _engine(model, graphs, card, former_mem_len=1,
                      latter_mem_len=8)
        before = _counts()
        chunks, _ = _serve(eng, raw, mask, augs, multi, chunk=5)
        torch.cuda.synchronize()
        runs[graphs] = (chunks, {k: n - before[k]
                                 for k, n in _counts().items()}, eng)
        del eng
        torch.cuda.empty_cache()
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]
    eng = runs[True][2]
    per_frame = len(augs) * (eng.cfg.model_lstt_num + 4) + 1
    assert (eng.graph_captures, eng.graph_replays, eng.eager_frames) == (
        per_frame, per_frame * 24, 1)


@pytest.mark.card
def test_graphs_are_freed_with_the_state(card):
    """The card's reserved memory after an engine and its states are
    dropped and the cache emptied is what it was before they were built,
    graphs or not: the graphs and their pool die with the states."""
    raw, mask = _video(4, CELL_RAW_HW, OBJECTS)
    capture_stream(card)    # once a process, with its cuBLAS workspaces
    reserved = []
    for graphs in (False, True, True):
        eng = _engine("r50_aotl", graphs, card)
        states = _serve(eng, raw, mask, CELL_AUGS, multi=True, chunk=4)[1]
        torch.cuda.synchronize()
        assert (states[0].graphs is not None) == graphs
        del eng, states
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(card))
    # the first run leaves the tables the ops cache; the graphs add nothing
    assert reserved[1] == reserved[0] and reserved[2] == reserved[0], reserved
