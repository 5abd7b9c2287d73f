"""Test and bench support: fault injection for the serving stage
(``faults``), SharedTree commit streams (``tree_streams``) and the packed
merge kernels' op streams of configs 2b and 4 (``merge_streams``)."""
