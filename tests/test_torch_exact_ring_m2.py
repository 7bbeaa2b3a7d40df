"""`dict_lt_input` at m2 (corpus.encode_cases: 40 KB of repetitive text
under a 32 KB dictionary), on the CPU through the plain versions of K5
and K3: under the exact parse and under the fast parse, which routes a
stream longer than its dictionary to the exact one, `encode_batch`
writes golden's bytes (csc_tpu.golden.encoder.encode_stream), where
csc_tpu's fast path writes a stream golden rejects; the golden decoder
and the port's decode_batch (K1's g++ build: its plain version reads a
ring stream in test_torch_exact_ring.py) read them back.  m1 is in
test_torch_exact_ring_m1.py."""
import shutil

import pytest

import torch_ring_cases as ring


def test_dict_lt_input_is_golden(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    ring.check_dict_lt_input(2, monkeypatch, tmp_path)
