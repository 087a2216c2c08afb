"""Multi-GPU execution: process groups (``mesh``), tensor-parallel serving
(``tp``) and the launcher that starts one process per rank (``launch``)."""
