"""The port's etree editor (``hercules_tpu_torch/etree/edit.py``)
against the JAX package's (``hercules_tpu/etree/edit.py``) on fixture
(a)'s CVM (``tools/makecvm``, through ``fixtures.write_box_case``; the
JAX package's own editor tests read the reference's simple example):
the same open, cursor walk, insert, delete, update and search sequence
on both editors gives equal results and raises alike, and the committed
databases are byte-equal."""

import numpy as np
import pytest

from hercules_tpu.etree.edit import (EtreeEditor as JaxEditor,
                                     EtreeError as JaxEtreeError)
from hercules_tpu_torch.cvm import CVM
from hercules_tpu_torch.etree.edit import EtreeEditor, EtreeError
from hercules_tpu_torch.etree.reader import EtreeReader
from hercules_tpu_torch.fixtures import LAYERS, TWO_LAYERS, write_box_case


@pytest.fixture(scope="module", params=["box", "two_layers"])
def box_e(request, tmp_path_factory):
    """fixture (a)'s box.e (one material), and the two-layer box's."""
    layers = {"box": LAYERS, "two_layers": TWO_LAYERS}[request.param]
    root = tmp_path_factory.mktemp(request.param)
    return write_box_case(str(root), 62.5, 1, 0, layers=layers)[0]


def _both(path):
    return EtreeEditor.open(path), JaxEditor.open(path)


def _same_editors(ed, jed):
    assert ed.n == jed.n
    for name in ("x", "y", "z", "level", "payload"):
        a, b = getattr(ed, name), getattr(jed, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_open_and_cursor_walk_match(box_e):
    """open() loads equal arrays; the preorder cursor walks the same
    octants and payloads in the reader's Z order, from the start and
    from a mid-tree address."""
    ed, jed = _both(box_e)
    _same_editors(ed, jed)
    r = EtreeReader(box_e, out_of_core=False)
    assert ed.n == r.total_count() == 2048
    x, y, z, lv, _ = r.octants()
    for start in ((0, 0, 0, 0), (int(x[700]), int(y[700]), int(z[700]), 0)):
        ed.initcursor(*start)
        jed.initcursor(*start)
        seen = 0
        while True:
            cur, jcur = ed.getcursor(), jed.getcursor()
            assert (cur is None) == (jcur is None)
            if cur is None:
                break
            assert cur[0] == jcur[0]
            assert np.array_equal(cur[1], jcur[1])
            seen += 1
            assert ed.advcursor() == jed.advcursor()
        assert seen == (ed.n if start[0] == 0 and start[1] == 0 else
                        ed.n - 700)


def _raises_alike(fn, jfn):
    with pytest.raises(EtreeError) as e:
        fn()
    with pytest.raises(JaxEtreeError) as je:
        jfn()
    assert str(e.value) == str(je.value)


def test_edit_sequence_matches_and_commits_the_same_bytes(box_e, tmp_path):
    """Delete an octant and re-insert it with another payload, delete a
    batch, update a batch (the top layer's Vs), insert the batch back;
    the errors of a repeated delete, an update of an absent octant and
    a duplicate insert; exact and region searches: equal on both
    editors after every step, and the committed files byte-equal and a
    CVM that answers with the patched values."""
    ed, jed = _both(box_e)
    pair = (ed, jed)
    ed.initcursor()
    addr, pay = ed.getcursor()
    a = (addr["x"], addr["y"], addr["z"], addr["level"])
    for e in pair:
        e.delete(*a)
    _same_editors(ed, jed)
    _raises_alike(lambda: ed.delete(*a), lambda: jed.delete(*a))
    _raises_alike(lambda: ed.update(*a, pay), lambda: jed.update(*a, pay))
    pay2 = pay.copy()
    pay2[0] ^= 1
    for e in pair:
        e.insert(*a, pay2)
    _same_editors(ed, jed)
    _raises_alike(lambda: ed.insert(*a, pay2), lambda: jed.insert(*a, pay2))

    r = EtreeReader(box_e, out_of_core=False)
    x, y, z, lv, rec = r.octants()
    sel = np.arange(5, 2048, 97)
    for e in pair:
        e.delete(x[sel], y[sel], z[sel], lv[sel])
    _same_editors(ed, jed)
    top = np.flatnonzero(z == 0)
    rows = rec[top].copy()
    rows["Vs"] = 1200.0
    raw = rows.view(np.uint8).reshape(len(top), -1)
    kept = np.setdiff1d(top, sel)
    kraw = rows[np.isin(top, kept)].view(np.uint8).reshape(len(kept), -1)
    for e in pair:
        e.update(x[kept], y[kept], z[kept], lv[kept], kraw)
    _same_editors(ed, jed)
    _raises_alike(lambda: ed.update(x[top], y[top], z[top], lv[top], raw),
                  lambda: jed.update(x[top], y[top], z[top], lv[top], raw))
    back = rec[sel].view(np.uint8).reshape(len(sel), -1)
    for e in pair:
        e.insert(x[sel], y[sel], z[sel], lv[sel], back)
    _same_editors(ed, jed)

    ok, rows_, pos = ed.search(x[::50], y[::50], z[::50], lv[::50])
    jok, jrows, jpos = jed.search(x[::50], y[::50], z[::50], lv[::50])
    assert ok.all() and np.array_equal(ok, jok)
    assert np.array_equal(rows_, jrows) and np.array_equal(pos, jpos)
    q = (x[::50] + 3, y[::50] + 5, z[::50] + 7)
    for got, want in zip(ed.search(*q), jed.search(*q)):
        assert np.array_equal(got, want)
    for got, want in zip(ed.search(*q, level=lv[::50]),
                         jed.search(*q, level=lv[::50])):
        assert np.array_equal(got, want)

    out, jout = tmp_path / "port.e", tmp_path / "jax.e"
    ed.commit(str(out))
    jed.commit(str(jout))
    assert out.read_bytes() == jout.read_bytes()
    pts = (np.array([10.0, 10.0]), np.array([10.0, 10.0]),
           np.array([1.0, 400.0]))
    ok, vp, vs, rho = CVM(str(out)).query(*pts)
    ok0, vp0, vs0, rho0 = CVM(box_e).query(*pts)
    assert ok.all() and ok0.all() and vs[0] == pytest.approx(1200.0)
    assert (vp[0], vs[1], vp[1]) == (vp0[0], vs0[1], vp0[1])


def test_empty_editor_matches(tmp_path):
    """A new editor: insert into the empty set, search, cursor and
    commit alike (payload 12 bytes, as the CVM's three float32)."""
    eds = [cls(12, asciischema="Vp(float);Vs(float);rho(float)")
           for cls in (EtreeEditor, JaxEditor)]
    xs = np.array([0, 1 << 29, 0], np.uint32)
    ys = np.array([0, 0, 1 << 29], np.uint32)
    zs = np.zeros(3, np.uint32)
    pay = np.arange(9, dtype=np.float32).reshape(3, 3)
    for e in eds:
        assert e.getcursor() is None
        e.insert(xs, ys, zs, 2, pay)
    _same_editors(*eds)
    for got, want in zip(eds[0].search(xs, ys, zs),
                         eds[1].search(xs, ys, zs)):
        assert np.array_equal(got, want)
    paths = [tmp_path / "a.e", tmp_path / "b.e"]
    for e, p in zip(eds, paths):
        e.commit(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()
