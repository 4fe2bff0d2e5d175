"""`correct` comes out false when the timed path is broken underneath,
once for each fault a cell can have, and for the control: the harness
runs on the CPU (the kernels' plain versions) at a small size, with
everything of a run but the look for a card."""
import copy
import json

import pytest
import torch

from tedabench import harness
from tedabench.control import FAULTS, control_factory, fault_factory

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = ["f32-backfill-t4096", "q-backfill-t4096"]


def tiny(name, channels=32, sampled=8):
    cell = harness.cell_spec(BENCH, name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["channels"] = channels
    cell.config["faults"]["length"] = [4, 30]
    cell.traffic.update(t=64, ring=8, stream_len=512,
                        sample_channels=sampled)
    return cell


class Broken:
    """A real engine with one fault planted in its timed path."""

    def __init__(self, eng, fault):
        self.eng, self.fault = eng, fault

    def reset(self):
        self.eng.reset()

    @property
    def state(self):
        return self.eng.state

    def process(self, x, valid_lens=None):
        eng = self.eng
        if self.fault == "state_unchanged":
            before = eng._parts
            out = eng.process(x, valid_lens=valid_lens)
            eng._parts = before
            return out
        if self.fault == "half_left_out":
            # the second half of the channels is never processed
            half = x.shape[1] // 2
            before = eng._parts[0]
            out = eng.process(x, valid_lens=valid_lens)
            st = eng._parts[0]
            eng._parts[0] = st._replace(**{
                f: torch.cat([getattr(st, f)[:half],
                              getattr(before, f)[half:]])
                for f in ("k", "mean", "var")})
            out = dict(out)
            out["outlier"] = out["outlier"].clone()
            out["outlier"][:, half:] = False
            out["ecc"] = out["ecc"].clone()
            out["ecc"][:, half:] = 0
            return out
        out = dict(eng.process(x, valid_lens=valid_lens))
        if self.fault == "flag_flipped":
            out["outlier"] = out["outlier"].clone()
            out["outlier"][-1, 3] = ~out["outlier"][-1, 3]
        elif self.fault == "ecc_altered":
            out["ecc"] = out["ecc"].clone()
            e = out["ecc"][-1, 5]
            out["ecc"][-1, 5] = e + 1 if not e.is_floating_point() \
                else e * 2
        return out


def run(cell, factory, seed=2 ** 40 + 9, calls=11, **size):
    return harness.run_cell(tiny(cell, **size), seed, 0.0, False, "cpu",
                            engine_factory=factory, calls=calls,
                            log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell, harness.make_engine)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "flag_flipped", "ecc_altered"])
def test_fault_is_caught(cell, fault):
    def factory(cfg, dev):
        return Broken(harness.make_engine(cfg, dev), fault)

    res = run(cell, factory)
    assert res["correct"] is False, (fault, res["checks"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_threshold_fault_is_caught(cell, fault):
    """A kernel whose threshold drops the +1 of (m^2 + 1)/(2k), or
    divides by k - 1: its flags differ from the reference's only near
    the threshold (within 10%, or 1/(k - 1)), past flag_margin's
    limit.  The k - 1 shift passes that limit only early in a stream,
    where few samples lie near their threshold: hence more channels,
    all of them followed through the stream."""
    res = run(cell, fault_factory(fault), channels=512, sampled=512)
    assert res["correct"] is False, (fault, res["checks"])
    failed = {n for n, c in res["checks"].items() if c["value"] > c["limit"]}
    # the flags and their counts fail, and nothing else
    assert failed and failed <= {"flag_margin", "summary_off_band",
                                 "flags_off", "summary_off"}, failed


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The configuration's lower precision in the program's place."""
    res = run(cell, control_factory, calls=8)
    assert res["correct"] is False, res["checks"]
