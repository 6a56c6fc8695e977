"""scripts/temporal_parts.py on the CPU: its refusal without a card and the
agreement of its tables with the kernels temporal_parts.cu dispatches.
The measurement itself needs a CUDA card (README, the port's section)."""

import re

import pytest
import torch

from latticeboltzmann_tpu_torch.scripts import temporal_parts as tp


def test_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tp.main(["--section", "parts"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_an_unknown_section_is_refused():
    with pytest.raises(SystemExit):
        tp.main(["--section", "flat"])


def test_compare_needs_a_parent_checkout(capsys):
    assert tp.main(["--section", "compare"]) == 2
    assert "--parent" in capsys.readouterr().err


def test_every_table_entry_is_a_kernel_the_source_dispatches():
    """Each (kind, variant) of the script's tables is a case of the .cu's
    dispatch (kind * 16 + variant), and each case is in a table; the
    designs swept over forced tile heights are among them."""
    cases = {int(n) for n in re.findall(r"case (\d+):", tp.SOURCE.read_text())}
    tables = {**tp.BYTES_ALONE, **tp.LEVELS_ALONE, **tp.DESIGNS}
    assert {16 * kind + variant for kind, variant in tables} == cases
    assert set(tp.FORCED) <= set(tables)
    assert len(set(tables.values())) == len(tables)
