"""Fleet-wide reductions and the packed multi-doc unpack."""
