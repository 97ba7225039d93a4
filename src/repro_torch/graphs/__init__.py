# numpy graph formats, partitions, generators and edge-update batches
# (copies of repro.graphs).
