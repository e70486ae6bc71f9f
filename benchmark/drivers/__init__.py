"""One driver per kind of cell, named by the cell's ``driver`` key."""
