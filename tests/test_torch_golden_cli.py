"""The port's golden CLIs (``scripts/make_golden.py``,
``scripts/check_golden.py``) against the JAX package's: the same
arguments make byte-equal files, and the check gives the same exit code
and verdict lines on a good pair and on one with a flipped byte."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.scripts import check_golden as jcheck_golden
from caltech_bifrost_dsp_tpu.scripts import make_golden as jmake_golden
from caltech_bifrost_dsp_tpu_torch.scripts import check_golden, make_golden
from caltech_bifrost_dsp_tpu_torch.verification import golden

torch.set_num_threads(1)

DIMS = ["-t", "96", "-c", "4", "-s", "6", "-p", "2", "--accshort", "24"]


@pytest.mark.parametrize("extra", [[], ["--chanramp"], ["--nocorr"],
                                   ["--seed", "7"]])
def test_make_golden_files_byte_equal(tmp_path, monkeypatch, capsys, extra):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    out = {}
    for name, mod in (("jax", jmake_golden), ("port", make_golden)):
        d = tmp_path / name
        d.mkdir()
        assert mod.main(DIMS + extra + ["--datapath", str(d)]) == 0
        out[name] = {f.name: f.read_bytes() for f in d.iterdir()}
    assert out["port"] == out["jax"]
    assert len(out["port"]) == (1 if "--nocorr" in extra else 2)
    assert capsys.readouterr().out.count("wrote") == 2 * len(out["port"])


def golden_pair(tmp_path):
    assert make_golden.main(DIMS + ["--datapath", str(tmp_path)]) == 0
    return (golden.input_filename(str(tmp_path), 96, 4, 6, 2),
            golden.corr_filename(str(tmp_path), 96, 24, 4, 6, 2))


def flip_byte(path, offset_from_end):
    raw = bytearray(path.read_bytes())
    raw[-offset_from_end] ^= 0x10
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("flip, max_blocks, rc", [
    (None, [], 0),
    ("corr", [], 1),        # a byte in the last block's visibilities
    ("input", [], 1),       # a sample of the last block
    ("corr", ["--max-blocks", "2"], 0),   # the flip lies past block 2
])
def test_check_golden_verdicts_match_jax(tmp_path, capsys, flip, max_blocks,
                                         rc):
    in_path, corr_path = golden_pair(tmp_path)
    capsys.readouterr()
    if flip:
        flip_byte(Path(corr_path if flip == "corr" else in_path), 100)
    verdicts = []
    for mod in (check_golden, jcheck_golden):
        assert mod.main([in_path, corr_path] + max_blocks) == rc
        verdicts.append(capsys.readouterr().out)
    assert verdicts[0] == verdicts[1]
    lines = verdicts[0].splitlines()
    nblock = 2 if max_blocks else 4
    assert len(lines) == nblock + 1
    assert lines[-1] == f"{nblock - rc}/{nblock} blocks verified"
    assert ("MISMATCH" in lines[-2]) == bool(rc)
    np.testing.assert_equal(rc, int(any("MISMATCH" in ln for ln in lines)))
