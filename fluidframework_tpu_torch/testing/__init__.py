"""Test and bench support: fault injection for the serving stage
(``faults``), SharedTree commit streams (``tree_streams``), the packed
merge kernels' op streams of configs 2b and 4 (``merge_streams``), the
pure-Python merge oracle (``oracle``), its fully-acked fuzz streams
(``fuzz``) and the multi-client load harness with fault injection
(``load``)."""
