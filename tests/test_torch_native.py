# -*- coding: utf-8 -*-
"""PyTorch port: the native C++ ASCII tokenizer (mcsas_tpu_torch/io/native.py
on the package's own copy of fastparse.cpp), built at first use into
build/native/.  The eight cases of the JAX package's tests/test_native.py,
every dialect fixture byte for byte against the port's Python parser and
the JAX package's native parser, and a build that fails raises."""
import glob

import numpy as np
import pytest

from mcsas_tpu.io import native as jax_native
from mcsas_tpu_torch.io import ascii as ascii_mod
from mcsas_tpu_torch.io import native
from mcsas_tpu_torch.io.ascii import (FileReadError, load_ascii, read_array,
                                      read_text_lines)


def test_all_fixtures_match_python(refdata):
    checked = 0
    jax_built = jax_native.available()
    for fn in sorted(glob.glob(str(refdata / "*"))):
        try:
            py = read_array(read_text_lines(fn), filename=fn)
        except Exception:
            continue
        nat = load_ascii(fn, use_native=True)
        assert nat.dtype == py.dtype and nat.shape == py.shape, fn
        assert nat.tobytes() == py.tobytes(), fn
        if jax_built:
            with open(fn, "rb") as fd:
                text = ascii_mod._decode(fd.read())
            assert jax_native.parse_text(text).tobytes() == nat.tobytes(), fn
        checked += 1
    assert checked >= 15
    if not jax_built:
        pytest.skip("the JAX package's native parser is not built here; "
                    "held against the port's Python parser only")


def test_parse_text_direct():
    arr = native.parse_text("header\n1,5 2,5\n1.0;2.0\n")
    # decimal-comma line then point line: both 2 columns
    np.testing.assert_array_equal(arr, [[1.5, 2.5], [1.0, 2.0]])


def test_parse_text_footer_stops():
    arr = native.parse_text("1 2\n3 4\nfooter\n5 6\n")
    np.testing.assert_array_equal(arr, [[1, 2], [3, 4]])


def test_parse_text_column_change_stops():
    arr = native.parse_text("1 2\n3 4\n5 6 7\n")
    np.testing.assert_array_equal(arr, [[1, 2], [3, 4]])


def test_parse_text_blank_lines_skipped():
    arr = native.parse_text("\n\n1 2\n\n3 4\n")
    np.testing.assert_array_equal(arr, [[1, 2], [3, 4]])


def test_parse_text_skip_lines():
    arr = native.parse_text("9 9\n8 8\n1 2\n", skip_lines=2)
    np.testing.assert_array_equal(arr, [[1, 2]])


def test_parse_text_no_data(tmp_path):
    """No table is a result (None); load_ascii then hands the text to the
    Python parser, which raises FileReadError as before."""
    assert native.parse_text("just words\n") is None
    path = tmp_path / "words.dat"
    path.write_text("just words\n")
    with pytest.raises(FileReadError):
        load_ascii(path, use_native=True)


def test_cr_only_endings():
    arr = native.parse_text("1;2\r3;4\r")
    np.testing.assert_array_equal(arr, [[1, 2], [3, 4]])


def test_built_into_build_native_by_source_hash():
    path = native.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path == native.library_path() and path.exists()
    assert path.stem.startswith("fastparse_")


def test_broken_source_raises(tmp_path, monkeypatch):
    """A source the compiler refuses raises with the compiler's output;
    nothing falls back to the Python parser."""
    broken = tmp_path / "fastparse.cpp"
    broken.write_text("this is not C++ {\n")
    monkeypatch.setattr(native, "_SRC", broken)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed with exit code") as err:
        native.parse_text("1 2\n")
    assert "error" in str(err.value)
    data = tmp_path / "d.dat"
    data.write_text("1 2\n3 4\n")
    with pytest.raises(RuntimeError):
        load_ascii(data)
    monkeypatch.setenv("MCSAS_TPU_NO_NATIVE", "1")
    np.testing.assert_array_equal(load_ascii(data), [[1, 2], [3, 4]])


def test_default_uses_native_unless_switched_off(tmp_path, monkeypatch):
    data = tmp_path / "d.dat"
    data.write_text("1 2\n3 4\n")
    calls = []
    real = native.parse_text
    monkeypatch.setattr(native, "parse_text",
                        lambda text, skip=0: calls.append(1) or real(text,
                                                                     skip))
    monkeypatch.delenv("MCSAS_TPU_NO_NATIVE", raising=False)
    load_ascii(data)
    assert calls == [1]
    monkeypatch.setenv("MCSAS_TPU_NO_NATIVE", "1")
    load_ascii(data)
    load_ascii(data, use_native=False)
    assert calls == [1]
