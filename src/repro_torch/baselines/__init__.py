"""The paper's comparison models: DLinear, PatchTST and FSLSTM."""
