"""How the harness drives the program, one module per kind of job; a
traffic file names its kind under ``job``.  Each module has a ``Job``:

* ``Job(cell, seed, device)``: the cell as ``common.find_cell`` gives it;
* ``setup()``: everything before the window: inputs and weights from the
  seed, the program's set-up, every shape the traffic uses warmed up and
  captured;
* ``window(seconds)``: the timed work, whole units of it until
  ``seconds`` have passed; returns a dict with ``elapsed_s``,
  ``attempted``, ``failed``, ``metrics`` (the end-to-end values) and
  ``work`` (what the per-layer readers count against the trace);
* ``release()``: frees the program's state before the check;
* ``readings(control=False)``: the numbers the check compares, against
  the plain reference (``benchmark/reference.py``), of the program or,
  with ``control``, of the reference computed in TF32.
"""
