"""The port's grammar automata (``ops/constrain.py``, ``ops/schema.py``)
held bit for bit against the JAX package's, on the CPU.

- the JSON pushdown automaton's packed token masks (``TokenTable.mask_for``)
  on every state that a set of JSON texts walks through, over a small
  vocabulary of single- and multi-byte pieces with an end-of-generation id
  (the JAX table fills its masks natively where it can build its library,
  the port's in Python: the two must agree);
- the device grammar tables (``GrammarTable.mask`` / ``.trans``) at caps 4
  and 64;
- ``compile_schema`` on supported and unsupported schemas, and the schema
  masks along an accepted text.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from ollama_operator_tpu.ops import constrain as JC
from ollama_operator_tpu.ops import schema as JS
from ollama_operator_tpu_torch.ops import constrain as C
from ollama_operator_tpu_torch.ops import schema as S

EOG = 0
PIECES = ([b""]                                    # id 0: EOG, no bytes
          + [bytes([b]) for b in b'{}[]":,-.e+ \n\\tfnu0123456789abx']
          + [b"true", b"false", b"null", b'"name"', b'": "', b"},",
             b'"a', b'b"', b"u00", b"12", b"e+", b"ab", b'{"', b'":',
             b'",', b'"}', b"\xc3\xa9", b"\xc3", b"\xa9"])

TEXTS = ['{"name": "ab", "age": 12, "tags": ["a", "b"], "ok": true}',
         '[{"x": "y\\n"}, null, -3.25, 1e+9]',
         ' { "k" : [ true , false ] } ',
         '"\\u00e9\\\\"', '[[[[[]]]]]', '-0.5', '{"a":{"b":[1,{"c":"d"}]}}',
         '"caf\xe9"']


def _tables():
    return (JC.TokenTable(PIECES, [EOG]), C.TokenTable(PIECES, [EOG]))


def _states(text: str):
    """Every packed PDA state the text walks through, the start first."""
    st, out = C.INITIAL_STATE, [C.INITIAL_STATE]
    for b in text.encode():
        st = C.advance_byte(st, b)
        assert st is not None, text
        out.append(st)
    return out


@pytest.mark.parametrize("text", TEXTS)
def test_token_masks_match_jax(text):
    jt, pt = _tables()
    states = _states(text)
    assert C.eos_ok(states[-1]) and JC.eos_ok(states[-1])
    json.loads(text)
    for st in states:
        np.testing.assert_array_equal(pt.mask_for(st), jt.mask_for(st),
                                      err_msg=repr(st))
    # the automaton itself agrees byte by byte
    jst = JC.INITIAL_STATE
    for b, st in zip(text.encode(), states[1:]):
        jst = JC.advance_byte(jst, b)
        assert jst == st


def test_json_constraint_walk_matches_jax():
    """A JsonConstraint fed the same tokens reports the same masks, the
    same legality and the same completion as the JAX one."""
    jt, pt = _tables()
    jc, pc = JC.JsonConstraint(jt), C.JsonConstraint(pt)
    ids = [PIECES.index(p) for p in
           (b'{"', b"a", b'":', b" ", b"true", b",", b'"name"', b":",
            b"[", b"12", b",", b"-", b"3", b"]", b"}")]
    for tid in ids:
        np.testing.assert_array_equal(pc.mask_row(), jc.mask_row())
        assert pc.advance(tid) == jc.advance(tid) is True
    assert pc.done and jc.done
    np.testing.assert_array_equal(pc.mask_row(), jc.mask_row())
    # complete at depth 0: only EOG is allowed
    assert pc.mask_row()[0] == np.uint32(1 << EOG)
    assert not pc.advance(PIECES.index(b"{")) and not pc.advance(1)


@pytest.mark.parametrize("cap", [4, 64])
def test_grammar_tables_match_jax(cap):
    jt, pt = _tables()
    jg = JC.GrammarTable(jt, cap=cap)
    pg = C.GrammarTable(pt, cap=cap)
    assert pg.states == jg.states
    assert pg.n_states <= cap
    np.testing.assert_array_equal(pg.mask, jg.mask)
    np.testing.assert_array_equal(pg.trans, jg.trans)
    assert C.GrammarTable.for_table(pt, cap=cap) is \
        C.GrammarTable.for_table(pt, cap=cap)
    for st in pg.states[:3] + [b"not a state", None]:
        assert pg.state_id(st) == jg.state_id(st)


PERSON = {"type": "object",
          "properties": {"name": {"type": "string"},
                         "age": {"type": "integer", "minimum": 0,
                                 "maximum": 150},
                         "kind": {"enum": ["a", "b", 12]},
                         "tags": {"type": "array",
                                  "items": {"type": "string"}},
                         "ok": {"type": "boolean"}},
          "required": ["name", "age", "kind", "tags", "ok"]}
SCHEMAS = [
    (PERSON, '{"name":"ab","age":12,"kind":"b","tags":["a","b"],"ok":true}'),
    ({"anyOf": [{"type": "integer"}, {"type": "null"}]}, "-12"),
    ({"type": "array", "items": {"type": "number"}, "minItems": 1},
     "[1.5,-0.5e+9]"),
    ({"type": "object", "properties": {"n": {"const": "x"},
                                       "v": {"type": "null"}}},
     '{"n":"x","v":null}'),
    ({"type": "string", "pattern": "^a"}, None),
    ({"type": "object", "properties": {"a": {"type": "string"}},
      "required": []}, None),
    ({"type": ["string", "null"]}, None),
    ({"type": "integer", "multipleOf": 3}, None),
]


@pytest.mark.parametrize("schema,text", SCHEMAS)
def test_schema_compile_and_masks_match_jax(schema, text):
    js, ps = JS.compile_schema(schema), S.compile_schema(schema)
    assert (ps is None) == (js is None) == (text is None)
    if text is None:
        return
    assert ps.root == js.root
    jt, pt = _tables()
    jst, pst = JS.machine_init(js.root), S.machine_init(ps.root)
    for b in text.encode():
        np.testing.assert_array_equal(ps.mask_for(pt, pst),
                                      js.mask_for(jt, jst))
        jst = JS.machine_advance(js.root, jst, b)
        pst = S.machine_advance(ps.root, pst, b)
        assert pst is not None and (jst is None) == (pst is None)
    assert S.machine_eos_ok(pst) and JS.machine_eos_ok(jst)
    np.testing.assert_array_equal(ps.mask_for(pt, pst), js.mask_for(jt, jst))
    json.loads(text)


def test_schema_constraint_matches_jax():
    jt, pt = _tables()
    js, ps = JS.compile_schema(PERSON), S.compile_schema(PERSON)
    jc, pc = JS.SchemaConstraint(js, jt), S.SchemaConstraint(ps, pt)
    ids = [PIECES.index(p) for p in
           (b"{", b'"name"', b":", b'"a', b'b"', b",")]
    for tid in ids:
        np.testing.assert_array_equal(pc.mask_row(), jc.mask_row())
        assert pc.advance(tid) == jc.advance(tid) is True
    assert not pc.done
    bad = PIECES.index(b"}")
    assert pc.advance(bad) == jc.advance(bad) is False
