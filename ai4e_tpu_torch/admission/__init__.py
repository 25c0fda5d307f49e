"""Deadline vocabulary of the serving path (counterpart of
``ai4e_tpu/admission``), cut to what the decode engine uses
(``deadline.py``); admission control itself is not ported (ROADMAP
A18.5)."""
