"""Adapters to the program under test (``rtdsd_tpu_torch``), one a model
family: the only modules of the benchmark that name the family's classes
and attributes in the program."""
