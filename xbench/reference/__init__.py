"""The plain reference: the X-engine's products worked out again in
float64 PyTorch from the inputs the harness made (:mod:`.xengine`), the
decoders of the product packets (:mod:`.decode`) and the comparison that
decides ``correct`` (:mod:`.check`).  Nothing here imports the port."""
