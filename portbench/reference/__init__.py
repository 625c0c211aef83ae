"""The plain float32 reference (:mod:`.model`) and the comparisons that
decide ``correct`` (:mod:`.compare`). Nothing here imports the port."""
