"""The reference's golden suite through the port.

``tests/test_golden.py`` runs the reference's recorded test cases
(``test_NNN/test.xml`` and the reference engine's ``model.bin``) through
the JAX package. Here the same harness, unedited, runs them through the
port: ``tests/_torch_golden.py`` maps every ``manticoresearch_tpu.*``
import of the harness to the port's module (no module of the JAX package
and no jax loads there) and makes "cpu" the default device of the port's
constructors.

- ``test_golden_on_port[<case>]``: one case per name that
  ``tests/golden/golden_scan.json`` records as passing (the list of
  ``tests/test_golden.py``), each held to its ``model.bin``. One
  subprocess runs them all, ``CASE_SECONDS`` per case and
  ``FILE_SECONDS`` in all; a case cut off or never reached fails with
  that reason. They are skipped only where the reference's test cases
  are not present.
- the alias: every name that ``tests/golden/runner.py`` and
  ``tests/golden/phpcustom.py`` import from ``manticoresearch_tpu.*``
  (read from their ASTs) binds the port's own object in that process.
- a rehearsal on synthetic cases in the reference's format (a plain
  index from an inline SQL source under several rankers with a range
  filter, an RT table through SphinxQL, ``endpoint=`` HTTP queries, a
  distributed index with an agent at ``127.0.0.1:7701``): every shaped
  result of the port equal to the JAX package's under the harness's own
  ``compare_result``, and docids and integer weights exactly equal; then
  the port's run of each against a ``model.bin`` recorded from the JAX
  package's results passes, and a model with one weight changed fails.

Tolerance: exact (the harness's comparison, then docids and weights).
"""
import ast
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from .golden.runner import GoldenEnv, compare_result
from .golden.testcase import TESTROOT, load_test
from .test_golden import PASSING
from ._torch_golden import CASE_SECONDS

REPO = Path(__file__).resolve().parent.parent
FILE_SECONDS = 600
HAVE_REFERENCE = os.path.isdir(TESTROOT)


def _port_golden(args: list, timeout: float) -> tuple[str, str, str]:
    """Run ``tests/_torch_golden.py``; returns (stdout, stderr, how it
    ended)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "tests._torch_golden", *args], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=timeout)
        return proc.stdout, proc.stderr, f"exit code {proc.returncode}"
    except subprocess.TimeoutExpired as e:
        def text(b):
            return b.decode(errors="replace") if isinstance(b, bytes) \
                else (b or "")
        return text(e.stdout), text(e.stderr), f"cut at {timeout} s"


def _json_lines(stdout: str) -> list:
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


# --------------------------------------------------------------------------
# the reference's cases
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_golden_runs():
    if not HAVE_REFERENCE:
        return None
    out, err, ended = _port_golden(PASSING, FILE_SECONDS)
    runs = {r["case"]: r for r in _json_lines(out)}
    return runs, f"the port's golden run ended ({ended}): {err[-1500:]}"


@pytest.mark.parametrize("dirname", PASSING)
def test_golden_on_port(dirname, port_golden_runs):
    if port_golden_runs is None:
        pytest.skip(f"the reference's test cases ({TESTROOT}) are not here")
    runs, ended = port_golden_runs
    assert dirname in runs, f"{dirname} not reached: {ended}"
    r = runs[dirname]
    assert r["passed"], f"{dirname} ({r['seconds']} s): " + "\n".join(
        r["failures"])


# --------------------------------------------------------------------------
# the alias
# --------------------------------------------------------------------------
def _harness_imports() -> list[str]:
    """``module:name`` of every ``from manticoresearch_tpu... import name``
    in the harness."""
    pairs = set()
    for rel in ("runner.py", "phpcustom.py"):
        path = REPO / "tests" / "golden" / rel
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.ImportFrom) and not node.level and (
                    node.module.split(".")[0] == "manticoresearch_tpu"):
                pairs.update(f"{node.module}:{a.name}" for a in node.names)
    return sorted(pairs)


def test_alias_binds_the_ports_objects():
    pairs = _harness_imports()
    assert len(pairs) >= 25
    assert {"manticoresearch_tpu.exec.session:Catalog",
            "manticoresearch_tpu.index.rt:RtIndex",
            "manticoresearch_tpu.server.http:HttpServer",
            "manticoresearch_tpu.index.builder:IndexBuilder",
            "manticoresearch_tpu.utils:uid"} <= set(pairs)
    out, err, ended = _port_golden(["--alias", *pairs], 120)
    assert ended == "exit code 0", err
    (got,) = _json_lines(out)
    assert got == {p: True for p in pairs}


# --------------------------------------------------------------------------
# the rehearsal on synthetic cases
# --------------------------------------------------------------------------
_PLAIN = """<?xml version="1.0" encoding="utf-8"?>
<test>
<name>plain index from an inline source: rankers and a range filter</name>
<config>
indexer
{
	mem_limit = 16M
}

searchd
{
	<searchd_settings/>
}

source srctest
{
	type = mysql
	<sql_settings/>
	sql_query = SELECT id, group_id, title, content FROM test_table
	sql_attr_uint = group_id
}

index test
{
	source = srctest
	path = <data_path/>/test
	<dynamic>
	<variant>morphology = none</variant>
	<variant>morphology = stem_en</variant>
	</dynamic>
}
</config>
<db_create>
CREATE TABLE test_table ( id INTEGER PRIMARY KEY NOT NULL, group_id INTEGER NOT NULL, title VARCHAR(255) NOT NULL, content VARCHAR(255) NOT NULL );
</db_create>
<db_insert>
INSERT INTO test_table VALUES
( 1, 1, 'test one', 'this is my test document number one. also checking search within phrases.' ),
( 2, 1, 'test two', 'this is my test document number two' ),
( 3, 2, 'another doc', 'this is another group' ),
( 4, 2, 'doc number four', 'this is to test groups' ),
( 5, 3, 'testing five', 'the tests are running numbers' ),
( 6, 3, 'numbers six', 'six documents test the rankers' );
</db_insert>
<queries>
<query>test</query>
<query ranker="bm25">test document</query>
<query ranker="proximity_bm25">"test document"</query>
<query ranker="wordcount">test | number</query>
<query ranker="none">this</query>
<query ranker="sph04">test number</query>
<query filter="group_id" filter_range="1 2">this</query>
<query mode="all">test number</query>
<query mode="any">numbers test</query>
<query sortmode="extended" sortby="group_id desc, @id asc">this</query>
</queries>
</test>
"""

_RT = """<?xml version="1.0" encoding="utf-8"?>
<test>
<name>RT index through SphinxQL: writes, GROUP BY, SHOW META</name>
<config>
searchd
{
	<searchd_settings/>
}

index rt
{
	type = rt
	path = <data_path/>/rt
	rt_field = title
	rt_field = content
	rt_attr_uint = gid
	rt_attr_string = tag
}
</config>
<queries>
<sphinxql>INSERT INTO rt (id, title, content, gid, tag) VALUES (1, 'red apple', 'fresh fruit from the tree', 1, 'a'), (2, 'green apple', 'sour fruit', 2, 'b'), (3, 'blue sky', 'clear day', 1, 'a'), (4, 'apple pie', 'baked apple fruit', 3, 'c')</sphinxql>
<sphinxql>SELECT id, gid, tag, WEIGHT() FROM rt WHERE MATCH('apple') ORDER BY id ASC</sphinxql>
<sphinxql>REPLACE INTO rt (id, title, content, gid, tag) VALUES (2, 'green apple pie', 'baked fruit', 3, 'c')</sphinxql>
<sphinxql>DELETE FROM rt WHERE id=3</sphinxql>
<sphinxql>INSERT INTO rt (id, title, content, gid, tag) VALUES (5, 'apple apple', 'fruit fruit fruit', 2, 'b')</sphinxql>
<sphinxql>SELECT id, gid, WEIGHT() w FROM rt WHERE MATCH('apple | fruit') ORDER BY w DESC, id ASC</sphinxql>
<sphinxql>SHOW META</sphinxql>
<sphinxql>SELECT gid, COUNT(*) c, SUM(id) s FROM rt WHERE MATCH('fruit') GROUP BY gid ORDER BY gid ASC</sphinxql>
<sphinxql>SHOW META</sphinxql>
<sphinxql>SELECT * FROM rt WHERE gid BETWEEN 2 AND 3 ORDER BY id DESC</sphinxql>
</queries>
</test>
"""

_HTTP = """<?xml version="1.0" encoding="utf-8"?>
<test>
<name>HTTP endpoint queries</name>
<config>
searchd
{
	<searchd_settings/>
}

index rt
{
	type = rt
	path = <data_path/>/rt
	rt_field = title
	rt_attr_uint = gid
}
</config>
<queries>
<sphinxql>INSERT INTO rt (id, title, gid) VALUES (1, 'red apple', 1), (2, 'green apple pie', 2), (3, 'blue sky', 1)</sphinxql>
<query endpoint="json/search">{"index":"rt","query":{"match":{"title":"apple"}}}</query>
<query endpoint="json/insert">{"index":"rt","id":7,"doc":{"title":"apple tree","gid":3}}</query>
<query endpoint="json/search">{"index":"rt","query":{"bool":{"must":[{"match":{"title":"apple"}},{"range":{"gid":{"gte":2}}}]}},"sort":[{"id":"asc"}]}</query>
<query endpoint="sql" method="POST">query=SELECT id, gid FROM rt WHERE MATCH('apple') ORDER BY id ASC</query>
<query endpoint="json/search">{"index":"rt","query":{"query_string":"sky | tree"},"limit":5}</query>
</queries>
</test>
"""

_DIST = """<?xml version="1.0" encoding="utf-8"?>
<test>
<name>distributed index with a remote agent</name>
<num_agents>2</num_agents>
<config>
indexer
{
	mem_limit = 16M
}

searchd
{
	<searchd_settings/>
}

source src
{
	type = mysql
	<sql_settings/>
	sql_query = SELECT id, gid, title FROM test_table WHERE id % 2 = <agent_id/>
	sql_attr_uint = gid
}

index part
{
	source = src
	path = <data_path/>/part<agent_id/>
}

<agent0>
index dist
{
	type = distributed
	local = part
	agent = 127.0.0.1:7701:part
}
</agent0>
</config>
<db_create>
CREATE TABLE test_table ( id INTEGER PRIMARY KEY NOT NULL, gid INTEGER NOT NULL, title VARCHAR(255) NOT NULL );
</db_create>
<db_insert>
INSERT INTO test_table VALUES
( 1, 1, 'red apple' ), ( 2, 1, 'green apple pie' ), ( 3, 2, 'blue sky' ),
( 4, 2, 'apple tree in the sky' ), ( 5, 3, 'an apple a day' ), ( 6, 3, 'sky high' );
</db_insert>
<queries>
<query index="dist">apple</query>
<query index="dist" ranker="bm25">apple | sky</query>
<query index="dist" sortmode="extended" sortby="gid desc, @id asc">sky</query>
<query index="dist" filter="gid" filter_value="3">apple</query>
<query index="dist" groupattr="gid" groupfunc="attr" groupsort="@group asc">apple | sky</query>
</queries>
</test>
"""

SYNTHETIC = {"test_s01_plain": _PLAIN, "test_s02_rt": _RT,
             "test_s03_http": _HTTP, "test_s04_dist": _DIST}
TAMPERED = "test_s05_tampered"     # test_s01_plain, one weight changed


def _php(v) -> bytes:
    """PHP ``serialize()`` of a shaped result (the format of model.bin)."""
    if v is None:
        return b"N;"
    if isinstance(v, bool):
        return b"b:%d;" % v
    if isinstance(v, int):
        return b"i:%d;" % v
    if isinstance(v, float):
        return b"d:%r;" % v
    if isinstance(v, str):
        raw = v.encode()
        return b's:%d:"%s";' % (len(raw), raw)
    items = v.items() if isinstance(v, dict) else enumerate(v)
    body = b"".join(_php(k) + _php(x) for k, x in items)
    return b"a:%d:{%s}" % (len(v), body)


def _jax_results(root: str, case: str) -> list:
    """Every shaped result of every subtest, in the JAX package."""
    from manticoresearch_tpu.utils import uid
    gt = load_test(case, root=root)
    out = []
    for st in range(gt.n_subtests):
        uid.reset()
        with tempfile.TemporaryDirectory() as td:
            env = GoldenEnv(gt, st, td)
            out.append([r for q in gt.queries if q.type != "comment"
                        for r in env.run_query(q)])
    return out


def _tamper(model: list) -> list:
    """The same results with the first match's weight off by one."""
    model = pickle.loads(pickle.dumps(model))
    matches = model[0][0]["matches"]
    first = next(iter(matches))
    matches[first]["weight"] = str(int(matches[first]["weight"]) + 1)
    return model


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    jax = {}
    for case, xml in SYNTHETIC.items():
        (root / case).mkdir()
        (root / case / "test.xml").write_text(xml)
        jax[case] = _jax_results(str(root), case)
    (root / TAMPERED).mkdir()
    (root / TAMPERED / "test.xml").write_text(_PLAIN)
    models = dict(jax, **{TAMPERED: _tamper(jax["test_s01_plain"])})
    for case, model in models.items():
        (root / case / "model.bin").write_bytes(_php(model))
    dump = root / "port.pkl"
    out, err, ended = _port_golden(
        ["--root", str(root), "--dump", str(dump), *SYNTHETIC], 120)
    assert ended == "exit code 0", err
    port = pickle.loads(dump.read_bytes())
    out, err, ended = _port_golden(["--root", str(root), *models], 120)
    assert ended == "exit code 0", err
    runs = {r["case"]: r for r in _json_lines(out)}
    return jax, port, runs


def _ids_weights(r: dict) -> list:
    """(docid, weight) of a shaped result: API matches, SphinxQL rows,
    HTTP hits."""
    if "matches" in r:
        return [(d, m["weight"]) for d, m in r["matches"].items()]
    if r.get("http"):
        hits = json.loads(r["rows"]).get("hits", {}).get("hits", [])
        return [(h["_id"], h["_score"]) for h in hits]
    rows = r.get("rows") or []
    return [(row.get("id"), row.get("weight()", row.get("w")))
            for row in (rows.values() if isinstance(rows, dict) else rows)]


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_case_equals_jax(case, rehearsal):
    jax, port, _ = rehearsal
    assert len(port[case]) == len(jax[case]) >= 1
    n = 0
    for st, (p_results, j_results) in enumerate(zip(port[case], jax[case])):
        assert len(p_results) == len(j_results)
        for i, (p, j) in enumerate(zip(p_results, j_results)):
            assert not j.get("error"), (st, i, j)
            assert compare_result(p, j) is None, (st, i)
            assert _ids_weights(p) == _ids_weights(j), (st, i)
            n += bool(_ids_weights(j))
    assert n >= 4     # each case finds documents in several queries


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_synthetic_case_passes_against_its_model(case, rehearsal):
    _, _, runs = rehearsal
    assert runs[case]["passed"], runs[case]["failures"]
    assert runs[case]["seconds"] < CASE_SECONDS


def test_synthetic_wrong_model_fails(rehearsal):
    _, _, runs = rehearsal
    r = runs[TAMPERED]
    assert not r["passed"]
    assert r["failures"][0].startswith("subtest 0: query 0 ")
