"""Client DDSes: SharedString with its interval collections, SharedMatrix,
SparseMatrix and SharedMap; SharedString's wire lowering is shared with the
service's device stage."""
