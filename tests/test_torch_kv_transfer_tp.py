"""Disaggregated prefill/decode across cards: KV pages that carry every
head, moved over the serving group (tp, fsdp or both), against the JAX
package.

One world-4 gloo job (``tests/torch_dist_worker.py kvtp_world4``) holds
first two tp = 2 replicas of ``llama2_tiny`` f32 (page 16): ranks 0-1 a
prefill replica, ranks 2-3 a decode replica, each on its own mesh; rank
0 also hosts one-process replicas.  Then the same ranks serve at fsdp >
1: a tp = 2 replica beside an fsdp = 2 one, and one fsdp = 2 x tp = 2
replica over all four (mesh ranks 0-1 its fsdp replica 0, 2-3 replica
1).  While it runs, the JAX references are computed here (the JAX tp = 2
and tp = 2 x fsdp = 2 replicas on the fake CPU devices of
``tests/conftest.py``).  Held, under tp:

1. a tp = 2 prefill replica hands off over HTTP to a tp = 2 decode
   replica (``llama2_tiny`` and ``mixtral_tiny``): the greedy tokens are
   the JAX unified server's;
2. tp 2 -> tp 1, tp 1 -> tp 2, JAX tp 2 -> port tp 2 and port tp 2 ->
   JAX tp 2 (pages cross as wire JSON through a file): all give the JAX
   unified tokens;
3. the port tp = 2 export equals the JAX tp = 2 export of a prompt;
4. after an import each decode rank's pool rows are its head chunk of
   the wire page, bit for bit (f32 and int8 pools, scales too);
5. dedup and reject verdicts are identical on every rank, a bad digest
   is rejected with its descendants everywhere, and a rank that stages
   other verdicts stops the group with ``TPPeerError``;
6. a planted head-order fault (the decode replica's rank 0 scatters the
   chunks swapped) is caught by the row check and by the logits.

The turn records of page operations carry headers only (a few hundred
bytes for three pages), the roles construct and serve under tp, and the
axes past tp and fsdp still raise in a serving mesh.  At fsdp > 1
(``test_fsdp_*``):

7. the port fsdp = 2 x tp = 2 export equals the JAX tp = 2 x fsdp = 2
   export, and only fsdp replica 0 gathers; an import is scattered over
   replica 0's tp group and broadcast over each fsdp group;
8. JAX tp x fsdp -> port fsdp x tp, port fsdp x tp -> JAX tp x fsdp,
   port tp = 2 -> port fsdp = 2, port fsdp = 2 -> port tp = 2, and
   ``mixtral_tiny`` at fsdp x tp both ways: all give the JAX unified
   tokens;
9. every rank of every fsdp replica holds its head chunk of the wire
   page bit for bit (f32 and int8 pools); the verdicts are identical on
   all four ranks, a rank of replica 1 that stages other verdicts stops
   the group, and followers run no page operation of their own;
10. a planted fault (rank 2 lands its fsdp broadcast's buffer before it
    is filled) is caught by the rows and by replica 1's logits.
"""

import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_operator_tpu.models import llama as jl
from mpi_operator_tpu.parallel import mesh as jmesh
from mpi_operator_tpu.serving import kv_transfer as jax_kv
from mpi_operator_tpu.serving.server import InferenceServer as JaxServer
from mpi_operator_tpu_torch.models import llama as tl
from mpi_operator_tpu_torch.models.params import from_flax_params
from mpi_operator_tpu_torch.parallel import mesh as tmesh
from mpi_operator_tpu_torch.serving import InferenceServer
from mpi_operator_tpu_torch.serving.batcher import prefix_page_digests
from test_torch_distributed import WORKER, join, launch

PAGE = 16
NEW = 8
LOGIT_TOL = 1e-4                       # f32 model logits (parity rules)
MODELS = {"dense": "llama2_tiny", "moe": "mixtral_tiny"}
# Five prompts of three full pages and three tokens (three transferable
# pages; a three-token suffix, never one token), from a seed.
_rng = np.random.default_rng(18)
PROMPTS = {k: [int(t) for t in _rng.integers(1, 256, 3 * PAGE + 3)]
           for k in "ABCEF"}


def _jax_server(model, variables, role="unified", kv="auto", tp=1, fsdp=1):
    mesh = None if tp * fsdp == 1 else jmesh.create_mesh(
        jmesh.MeshConfig(dp=1, fsdp=fsdp, tp=tp),
        devices=jax.devices()[:tp * fsdp])
    return JaxServer(model, variables, mesh=mesh, max_batch_slots=2,
                     kv_page_size=PAGE, kv_cache_blocks=48,
                     kv_cache_dtype=kv, role=role).start()


def _jax_tokens(server, prompt):
    return server._batcher.submit(prompt, NEW, timeout=120)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_kvtp")
    jax_models = {}
    for name, preset in MODELS.items():
        model = jl.LlamaModel(getattr(jl, preset)())
        jax_models[name] = (model, model.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 4), jnp.int32)))
    weights = {name: (MODELS[name], {}, from_flax_params(
        jax.tree_util.tree_map(np.asarray, v["params"]),
        getattr(tl, MODELS[name])(), torch.float32))
        for name, (_, v) in jax_models.items()}
    jm, jv = jax_models["dense"]
    # The JAX tp = 2 prefill replica's pages of prompt C, for the decode
    # replica of the job (and test 3).
    jax_prefill = _jax_server(jm, jv, role="prefill", tp=2)
    try:
        jax_prefill._batcher.submit(PROMPTS["C"], 1, timeout=120)
        jax_export = jax_kv.encode_pages(jax_prefill._batcher.export_kv_pages(
            prefix_page_digests(PROMPTS["C"], PAGE)))
    finally:
        jax_prefill.stop()
    wire_path = out / "jax_C.json"
    wire_path.write_text(json.dumps(jax_export))
    # The JAX tp = 2 x fsdp = 2 replica's pages of A (held to the port's
    # fsdp x tp export) and C (for the port's fsdp x tp replica).
    jax_fsdp = _jax_server(jm, jv, role="prefill", tp=2, fsdp=2)
    try:
        jax_fsdp_export = {}
        for k in "AC":
            jax_fsdp._batcher.submit(PROMPTS[k], 1, timeout=120)
            jax_fsdp_export[k] = jax_kv.encode_pages(
                jax_fsdp._batcher.export_kv_pages(
                    prefix_page_digests(PROMPTS[k], PAGE)))
    finally:
        jax_fsdp.stop()
    fsdp_wire = out / "jax_fsdp_C.json"
    fsdp_wire.write_text(json.dumps(jax_fsdp_export["C"]))
    torch.save({"models": weights, "prompts": PROMPTS,
                "jax_wire": str(wire_path),
                "jax_fsdp_wire": str(fsdp_wire)}, out / "inputs.pt")
    procs = launch([sys.executable, WORKER, "kvtp_world4", str(out)], 4,
                   str(out))
    t0 = time.monotonic()
    refs = {"jax_export": jax_export, "jax_fsdp_export": jax_fsdp_export}
    unified = _jax_server(jm, jv)
    try:
        refs["unified"] = {k: _jax_tokens(unified, p)
                           for k, p in PROMPTS.items()}
    finally:
        unified.stop()
    int8 = _jax_server(jm, jv, kv="int8")
    try:
        refs["unified_int8"] = _jax_tokens(int8, PROMPTS["A"])
    finally:
        int8.stop()
    mm, mv = jax_models["moe"]
    moe = _jax_server(mm, mv)
    try:
        refs["unified_moe"] = _jax_tokens(moe, PROMPTS["A"])
        refs["unified_moe_b"] = _jax_tokens(moe, PROMPTS["B"])
    finally:
        moe.stop()
    refs["logits"] = {k: np.asarray(jm.apply(jv, jnp.asarray(
        [PROMPTS[k]], jnp.int32)))[0, -1] for k in ("A", "C", "F")}
    join(procs, str(out))
    refs["seconds"] = time.monotonic() - t0
    refs["ranks"] = [torch.load(out / f"kvtp_world4.rank{r}.pt",
                                weights_only=False) for r in range(4)]
    # port tp = 2 -> JAX tp = 2: the port's wire file into a JAX tp = 2
    # decode replica.
    with open(refs["ranks"][0]["files"]["A"]) as f:
        port_a = json.load(f)
    decode = _jax_server(jm, jv, role="decode", tp=2)
    try:
        refs["port_to_jax_reply"] = decode._batcher.import_kv_pages(
            jax_kv.decode_pages(port_a))
        refs["port_to_jax"] = _jax_tokens(decode, PROMPTS["A"])
        refs["port_to_jax_hits"] = decode._batcher.prefix_stats["hit_blocks"]
    finally:
        decode.stop()
    with open(refs["ranks"][0]["files"]["C"]) as f:
        refs["port_export_c"] = json.load(f)
    # port fsdp x tp -> JAX tp x fsdp: the port's export of A.
    with open(refs["ranks"][0]["files"]["A_fsdp"]) as f:
        refs["port_fsdp_export_a"] = json.load(f)
    decode = _jax_server(jm, jv, role="decode", tp=2, fsdp=2)
    try:
        refs["port_fsdp_to_jax_reply"] = decode._batcher.import_kv_pages(
            jax_kv.decode_pages(refs["port_fsdp_export_a"]))
        refs["port_fsdp_to_jax"] = _jax_tokens(decode, PROMPTS["A"])
        refs["port_fsdp_to_jax_hits"] = \
            decode._batcher.prefix_stats["hit_blocks"]
    finally:
        decode.stop()
    return refs


def _shipped_all(reply, pages=3):
    return (reply["shipped"], reply["imported"], reply["rejected"]) == \
        (pages, pages, 0)


# -- 1. tp 2 -> tp 2 over HTTP ---------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_tp2_prefill_hands_off_to_tp2_decode_over_http(runs, name):
    rank0 = runs["ranks"][0]
    if name == "dense":
        drive = rank0["drive"]
        assert _shipped_all(drive["tp2_tp2_reply"])
        assert drive["tp2_tp2"] == runs["unified"]["A"]
        # The prefill replica ran no decode step, on either rank.
        assert drive["tp2_prefill_dispatches"] == 0
        assert [r["dispatches"] for r in runs["ranks"][:2]] == [0, 0]
    else:
        assert _shipped_all(rank0["moe_reply"])
        assert rank0["moe"] == runs["unified_moe"]


def test_reship_reports_every_page_deduped(runs):
    reship = runs["ranks"][0]["drive"]["reship"]
    assert (reship["shipped"], reship["deduped"], reship["imported"]) == \
        (3, 3, 0)


# -- 2. across tp and across the packages ----------------------------------

@pytest.mark.parametrize("direction,prompt", [
    ("tp2_tp1", "A"), ("tp1_tp2", "B"), ("jax_tp2", "C")])
def test_handoff_across_tp_gives_the_jax_unified_tokens(runs, direction,
                                                         prompt):
    drive = runs["ranks"][0]["drive"]
    reply = drive[f"{direction}_reply"]
    assert reply["imported"] == 3 and reply["rejected"] == 0, reply
    assert drive[direction] == runs["unified"][prompt]


def test_port_tp2_pages_serve_a_jax_tp2_decode_replica(runs):
    assert runs["port_to_jax_reply"] == {"imported": 3, "deduped": 0,
                                         "rejected": 0}
    assert runs["port_to_jax"] == runs["unified"]["A"]
    assert runs["port_to_jax_hits"] == 3


def test_decode_replica_prefills_only_the_tail(runs):
    """Every prompt handed to the decode replica hit all its pages
    (A, B, C, F: 12), the same count on both ranks."""
    hits = [r["prefix"]["hit_blocks"] for r in runs["ranks"][2:]]
    assert hits == [12, 12]


# -- 3. the export ---------------------------------------------------------

def test_port_tp2_export_equals_the_jax_tp2_export(runs):
    _exports_equal(runs["port_export_c"], runs["jax_export"])


def _exports_equal(port, want):
    assert [(p["digest"], p["parent"], p["tokens"]) for p in port] == \
        [(p["digest"], p["parent"], p["tokens"]) for p in want]
    for got, ref in zip(port, want):
        assert got["leaves"].keys() == ref["leaves"].keys()
        for path, spec in ref["leaves"].items():
            mine = got["leaves"][path]
            assert (mine["dtype"], mine["shape"]) == \
                (spec["dtype"], spec["shape"])
            # Every KV head of llama2_tiny (4), in the JAX order.
            assert spec["shape"][1] == 4
            np.testing.assert_allclose(
                jax_kv.decode_leaf(mine), jax_kv.decode_leaf(spec),
                atol=1e-5, rtol=0, err_msg=path)


# -- 4. pool rows ----------------------------------------------------------

@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_each_rank_holds_its_head_chunk_of_the_wire_bit_for_bit(runs, kv):
    for rank in runs["ranks"][2:]:
        rows = rank["rows"]["A"] if kv == "auto" else \
            rank["int8_report"]["rows"]
        assert rows and all(rows.values()), rows
        if kv == "int8":
            assert any(path.endswith("_scale") for path in rows)
    if kv == "int8":
        assert runs["ranks"][0]["int8"] == runs["unified_int8"]


# -- 5. verdicts -----------------------------------------------------------

def test_verdicts_are_identical_on_every_rank(runs):
    drive = runs["ranks"][0]["drive"]
    verdicts = {k: [drive[k][v] for v in ("imported", "deduped", "rejected")]
                for k in ("bad_reply", "dedup_reply")}
    assert verdicts == {"bad_reply": [0, 0, 3], "dedup_reply": [0, 3, 0]}
    for pair in (runs["ranks"][:2], runs["ranks"][2:]):
        assert pair[0]["page_ops"] == pair[1]["page_ops"]
    reasons = [v for kind, verdicts in runs["ranks"][2]["page_ops"]
               for v in verdicts if kind == "import" and v[0] == "rejected"]
    assert reasons == [("rejected", "digest_mismatch"),
                       ("rejected", "missing_parent"),
                       ("rejected", "missing_parent")]


def test_a_rank_staging_other_verdicts_stops_the_group(runs):
    for rank in runs["ranks"][2:]:
        (error,) = rank["peer_error"]
        assert "TPPeerError" in error and "kv-import" in error, error


def test_followers_run_no_page_operations_of_their_own(runs):
    assert "rank 0 of the group queues them" in \
        runs["ranks"][3]["follower_import"]


# -- 6. the planted head-order fault ---------------------------------------

def test_planted_head_order_fault_is_caught(runs):
    """D's rank 0 scatters rank 1's chunk to itself and its own to rank
    1: the rows of prompt F are not the ranks' chunks, and its logits
    over the imported pages leave the JAX model's; prompt A, imported
    before the fault, matches both."""
    assert _shipped_all(runs["ranks"][0]["drive"]["fault_reply"])
    for rank in runs["ranks"][2:]:
        assert all(rank["rows"]["A"].values())
        assert not any(rank["rows"]["F"].values())
        logits = {k: v.numpy() for k, v in rank["logits"].items()}
        np.testing.assert_allclose(logits["A"], runs["logits"]["A"],
                                   atol=LOGIT_TOL, rtol=0)
        assert np.abs(logits["F"] - runs["logits"]["F"]).max() > 100 * \
            LOGIT_TOL


# -- the record, the roles, the axes ---------------------------------------

def test_page_records_carry_headers_only(runs):
    """A turn record with page operations (three pages: digests,
    parents, tokens, one table of leaf shapes) stays under 4 KB; the
    leaves (3 x 4 x 16 x 4 x 32 x 4 bytes of f32) never ride it.  Rank 0
    of each replica sends them; the other rank's records hold none."""
    sizes = [r["record_bytes"] for r in runs["ranks"]]
    assert 0 < sizes[0] < 4096 and 0 < sizes[2] < 4096, sizes
    assert sizes[1] == sizes[3] == 0, sizes


@pytest.mark.parametrize("role,rank", [("prefill", 0), ("decode", 2)])
def test_roles_construct_and_serve_under_tp(runs, role, rank):
    assert runs["ranks"][rank]["role"] == role


def _fake_mesh(**axes):
    shape = tuple(axes.get(a, 1) for a in tmesh.AXIS_NAMES)
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_NAMES,
                                 shape=shape,
                                 get_local_rank=lambda axis: 0,
                                 get_group=lambda axis: None)


@pytest.mark.parametrize("axis", ["dp", "sp", "ep"])
def test_serving_mesh_axes_past_tp_still_raise(axis):
    model = tl.LlamaModel(tl.llama2_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 3 "):
        InferenceServer(model, mesh=_fake_mesh(**{axis: 2, "tp": 2}),
                        role="decode", max_batch_slots=2, kv_page_size=16,
                        device="cpu")


# -- 7.-10. at fsdp > 1 ----------------------------------------------------

def _fsdp(runs, rank, key="fsdp_tp"):
    return runs["ranks"][rank][key]


def test_fsdp_tp_export_equals_the_jax_tp_fsdp_export(runs):
    with open(runs["ranks"][0]["files"]["A_fsdp"]) as f:
        port = json.load(f)
    _exports_equal(port, runs["jax_fsdp_export"]["A"])


def test_fsdp_only_replica_0_moves_an_export_and_an_import_reaches_all(
        runs):
    """One export (A, one wave) gathers on fsdp replica 0's two ranks
    only; an import wave (the JAX C pages, then F's) is scattered over
    replica 0's tp group and broadcast over both fsdp groups, once a
    wave on every rank; a dedup and a rejected chain move nothing."""
    counts = [_fsdp(runs, r)["collectives"] for r in range(4)]
    assert [c["gather"] for c in counts] == [1, 1, 0, 0], counts
    assert [c["scatter"] for c in counts] == [2, 2, 0, 0], counts
    assert [c["broadcast"] for c in counts] == [2, 2, 2, 2], counts
    before = [_fsdp(runs, r)["counts_before_fault"] for r in range(4)]
    assert [c["broadcast"] for c in before] == [1, 1, 1, 1], before


@pytest.mark.parametrize("direction", [
    "jax_tp_fsdp_to_port_fsdp_tp", "port_fsdp_tp_to_jax_tp_fsdp",
    "port_tp2_to_port_fsdp2", "port_fsdp2_to_port_tp2"])
def test_fsdp_handoffs_give_the_jax_unified_tokens(runs, direction):
    unified = runs["unified"]
    f, mixed = _fsdp(runs, 0), _fsdp(runs, 0, "mixed")
    reply, tokens, want = {
        "jax_tp_fsdp_to_port_fsdp_tp": (f["jax_reply"], f["jax"],
                                        unified["C"]),
        "port_fsdp_tp_to_jax_tp_fsdp": (runs["port_fsdp_to_jax_reply"],
                                        runs["port_fsdp_to_jax"],
                                        unified["A"]),
        "port_tp2_to_port_fsdp2": (mixed["tp2_fsdp2_reply"],
                                   mixed["tp2_fsdp2"], unified["A"]),
        "port_fsdp2_to_port_tp2": (mixed["fsdp2_tp2_reply"],
                                   mixed["fsdp2_tp2"], unified["B"]),
    }[direction]
    assert reply["imported"] == 3 and reply["rejected"] == 0, reply
    assert tokens == want
    if direction == "port_fsdp_tp_to_jax_tp_fsdp":
        assert runs["port_fsdp_to_jax_hits"] == 3


@pytest.mark.parametrize("way", ["export", "import"])
def test_fsdp_tp_mixtral_hands_off_both_ways(runs, way):
    moe = _fsdp(runs, 0, "fsdp_tp_moe")
    assert moe[f"{way}_reply"]["imported"] == 3, moe[f"{way}_reply"]
    assert moe[way] == (runs["unified_moe_b"] if way == "export"
                        else runs["unified_moe"])


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_fsdp_every_rank_holds_its_head_chunk_bit_for_bit(runs, kv):
    """All four ranks of the fsdp x tp replica (and both ranks of the
    fsdp = 2 one, for f32), scales included for int8."""
    for r in range(4):
        rows = (_fsdp(runs, r)["rows"]["C"] if kv == "auto" else
                _fsdp(runs, r, "fsdp_tp_int8")["rows"])
        assert rows and all(rows.values()), (r, rows)
        if kv == "int8":
            assert any(path.endswith("_scale") for path in rows)
    if kv == "auto":
        for r in (2, 3):
            rows = _fsdp(runs, r, "mixed")["rows"]
            assert rows and all(rows.values()), (r, rows)
    else:
        i8 = _fsdp(runs, 0, "fsdp_tp_int8")
        assert i8["reply"]["imported"] == 3, i8["reply"]
        assert i8["tokens"] == runs["unified_int8"]


def test_fsdp_verdicts_are_identical_on_every_rank(runs):
    f = _fsdp(runs, 0)
    assert [f["dedup_reply"][k] for k in ("imported", "deduped",
                                          "rejected")] == [0, 3, 0]
    assert [f["bad_reply"][k] for k in ("imported", "deduped",
                                        "rejected")] == [0, 0, 3]
    ops = [_fsdp(runs, r)["page_ops"] for r in range(4)]
    assert ops[0] and all(o == ops[0] for o in ops), ops
    mixed = [_fsdp(runs, r, "mixed")["page_ops"] for r in (2, 3)]
    assert mixed[0] and mixed[0] == mixed[1]


def test_fsdp_a_rank_staging_other_verdicts_stops_the_group(runs):
    for rank in runs["ranks"]:
        (error,) = rank["fsdp_peer_error"]
        assert "TPPeerError" in error and "kv-import" in error, error


def test_fsdp_followers_run_no_page_operations_of_their_own(runs):
    assert "rank 0 of the group queues them" in \
        _fsdp(runs, 2)["follower_import"]


def test_fsdp_planted_fault_on_replica_1_is_caught(runs):
    """Rank 2 lands its fsdp broadcast's buffer before it is filled for
    F's pages: its rows of F are not its head chunk (ranks 0, 1 and 3
    hold theirs), and replica 1's logits of F leave the JAX model's
    while replica 0's, and both replicas' of C, match."""
    assert _fsdp(runs, 0)["fault_reply"]["imported"] == 3
    for r in range(4):
        f = _fsdp(runs, r)
        assert all(f["rows"]["C"].values())
        assert any(f["rows"]["F"].values()) == (r != 2), (r, f["rows"])
        assert all(f["rows"]["F"].values()) == (r != 2), (r, f["rows"])
        logits = {k: v.numpy() for k, v in f["logits"].items()}
        np.testing.assert_allclose(logits["C"], runs["logits"]["C"],
                                   atol=LOGIT_TOL, rtol=0)
        close = np.allclose(logits["F"], runs["logits"]["F"],
                            atol=LOGIT_TOL, rtol=0)
        assert close == (r < 2), (r, np.abs(logits["F"]
                                            - runs["logits"]["F"]).max())


@pytest.mark.parametrize("role,key", [("prefill", "fsdp_tp_moe"),
                                      ("decode", "fsdp_tp")])
def test_roles_construct_and_serve_at_fsdp(runs, role, key):
    assert _fsdp(runs, 0, key)["role"] == role
    if role == "decode":
        assert _fsdp(runs, 2, "mixed")["role"] == role


def test_the_job_stays_inside_its_deadline(runs):
    """The job (four processes, JAX references beside it) keeps well
    inside the worker deadline of ``join``."""
    assert runs["seconds"] < 300, runs["seconds"]
