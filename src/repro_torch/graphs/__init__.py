# numpy graph formats, partitions and generators (copies of repro.graphs).
