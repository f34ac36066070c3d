"""Hand-built binary GraphDef fixtures, written with the port's protowire
(``bigdl_tpu_torch.utils.protowire``; no JAX): the port-side twin of
``tests/tfgraph_util.py``, used by the port's TF tests on the CPU and on
the card."""

import numpy as np

from bigdl_tpu_torch.utils import protowire as pw


def node(name, op, inputs=(), **attrs):
    body = pw.enc_str(1, name) + pw.enc_str(2, op)
    for i in inputs:
        body += pw.enc_str(3, i)
    for k, v in attrs.items():
        body += pw.enc_bytes(5, pw.enc_str(1, k) + pw.enc_bytes(2, v))
    return pw.enc_bytes(1, body)


def attr_tensor(arr):
    """float32 TensorProto attr payload."""
    arr = np.asarray(arr, np.float32)
    t = pw.enc_varint(1, 1)  # DT_FLOAT
    shp = b"".join(pw.enc_bytes(2, pw.enc_varint(1, d)) for d in arr.shape)
    t += pw.enc_bytes(2, shp)
    t += pw.enc_bytes(4, arr.tobytes())
    return pw.enc_bytes(8, t)


def scalar_const(v):
    t = (pw.enc_varint(1, 1) + pw.enc_bytes(2, b"")
         + pw.enc_bytes(4, np.float32(v).tobytes()))
    return pw.enc_bytes(8, t)


def shape_const(dims):
    """int32 shape-vector TensorProto attr payload."""
    t = pw.enc_varint(1, 3)  # DT_INT32
    shp = pw.enc_bytes(2, pw.enc_varint(1, len(dims)))
    t += pw.enc_bytes(2, shp)
    t += pw.enc_bytes(4, np.asarray(dims, np.int32).tobytes())
    return pw.enc_bytes(8, t)


def string_const(strings):
    """DT_STRING vector TensorProto attr payload."""
    t = pw.enc_varint(1, 7)  # DT_STRING
    shp = pw.enc_bytes(2, pw.enc_varint(1, len(strings)))
    t += pw.enc_bytes(2, shp)
    for s in strings:
        t += pw.enc_bytes(8, s.encode() if isinstance(s, str) else s)
    return pw.enc_bytes(8, t)


def int_scalar_const(v):
    """int32 scalar TensorProto attr payload."""
    t = (pw.enc_varint(1, 3) + pw.enc_bytes(2, b"")
         + pw.enc_bytes(4, np.int32(v).tobytes()))
    return pw.enc_bytes(8, t)


def attr_int(v):
    """integer AttrValue payload (field 3 = i)."""
    return pw.enc_varint(3, int(v))


def attr_type(v):
    """type-enum AttrValue payload (field 6 = type)."""
    return pw.enc_varint(6, int(v))


def enter(name, inputs, frame):
    """Enter node with a frame_name attr (while-loop fixtures)."""
    body = pw.enc_str(1, name) + pw.enc_str(2, "Enter")
    for i in inputs:
        body += pw.enc_str(3, i)
    body += pw.enc_bytes(5, pw.enc_str(1, "frame_name")
                         + pw.enc_bytes(2, pw.enc_bytes(2, frame.encode())))
    return pw.enc_bytes(1, body)


def while_graph():
    """while (i < 5): i += 1; acc *= 2 — two loop variables fed by
    placeholders (a dynamic trip count)."""
    return (node("i0", "Placeholder")
            + node("acc0", "Placeholder")
            + enter("i_ent", ["i0"], "loop")
            + enter("acc_ent", ["acc0"], "loop")
            + node("i_mrg", "Merge", ["i_ent", "i_nextit"])
            + node("acc_mrg", "Merge", ["acc_ent", "acc_nextit"])
            + node("five", "Const", value=scalar_const(5.0))
            + node("lt", "Less", ["i_mrg", "five"])
            + node("lc", "LoopCond", ["lt"])
            + node("i_sw", "Switch", ["i_mrg", "lc"])
            + node("acc_sw", "Switch", ["acc_mrg", "lc"])
            + node("one", "Const", value=scalar_const(1.0))
            + node("two", "Const", value=scalar_const(2.0))
            + node("i_add", "Add", ["i_sw:1", "one"])
            + node("acc_mul", "Mul", ["acc_sw:1", "two"])
            + node("i_nextit", "NextIteration", ["i_add"])
            + node("acc_nextit", "NextIteration", ["acc_mul"])
            + node("i_exit", "Exit", ["i_sw:0"])
            + node("acc_exit", "Exit", ["acc_sw:0"])
            + node("out", "Identity", ["acc_exit"]))


def nested_loop_graph(outer=3.0, inner=2.0):
    """outer (i < outer): { inner (j < inner): acc = acc * 2 + w }: two
    loop variables in the outer frame, a nested frame in its body, and a
    tensor carry ``acc`` (shape of the ``acc0`` feed).  Each step is one
    correctly rounded multiply and one add, so every device gets the same
    bits."""
    return (node("acc0", "Placeholder")
            + node("w", "Placeholder")
            + node("zero", "Const", value=scalar_const(0.0))
            + node("one", "Const", value=scalar_const(1.0))
            + node("two", "Const", value=scalar_const(2.0))
            + node("n_out", "Const", value=scalar_const(outer))
            + node("n_in", "Const", value=scalar_const(inner))
            + enter("i_ent", ["zero"], "outer")
            + enter("acc_ent", ["acc0"], "outer")
            + node("i_mrg", "Merge", ["i_ent", "i_ni"])
            + node("acc_mrg", "Merge", ["acc_ent", "acc_ni"])
            + node("lt", "Less", ["i_mrg", "n_out"])
            + node("lc", "LoopCond", ["lt"])
            + node("i_sw", "Switch", ["i_mrg", "lc"])
            + node("acc_sw", "Switch", ["acc_mrg", "lc"])
            + enter("j_ent", ["zero"], "inner")
            + enter("a_ent", ["acc_sw:1"], "inner")
            + enter("w_ent", ["w"], "inner")
            + node("j_mrg", "Merge", ["j_ent", "j_ni"])
            + node("a_mrg", "Merge", ["a_ent", "a_ni"])
            + node("ltj", "Less", ["j_mrg", "n_in"])
            + node("lcj", "LoopCond", ["ltj"])
            + node("j_sw", "Switch", ["j_mrg", "lcj"])
            + node("a_sw", "Switch", ["a_mrg", "lcj"])
            + node("j_add", "Add", ["j_sw:1", "one"])
            + node("a_mul", "Mul", ["a_sw:1", "two"])
            + node("a_new", "Add", ["a_mul", "w_ent"])
            + node("j_ni", "NextIteration", ["j_add"])
            + node("a_ni", "NextIteration", ["a_new"])
            + node("j_exit", "Exit", ["j_sw:0"])
            + node("a_exit", "Exit", ["a_sw:0"])
            + node("i_add", "Add", ["i_sw:1", "one"])
            + node("i_ni", "NextIteration", ["i_add"])
            + node("acc_ni", "NextIteration", ["a_exit"])
            + node("i_exit", "Exit", ["i_sw:0"])
            + node("acc_exit", "Exit", ["acc_sw:0"])
            + node("out", "Identity", ["acc_exit"]))


def dynrnn_graph(T, B, I, H, rng):
    """A dynamic-RNN export: the input scattered into a TensorArray, a
    while loop reading x_t and writing h_t through TensorArray ops, and a
    TensorArrayGather of the outputs after it.  Returns (graph, W, U)."""
    W = rng.normal(0, 0.5, (I, H)).astype(np.float32)
    U = rng.normal(0, 0.5, (H, H)).astype(np.float32)
    idx_t = pw.enc_bytes(8, (pw.enc_varint(1, 3)
                             + pw.enc_bytes(2, pw.enc_bytes(
                                 2, pw.enc_varint(1, T)))
                             + pw.enc_bytes(4, np.arange(
                                 T, dtype=np.int32).tobytes())))
    g = (node("x", "Placeholder")
         + node("Wc", "Const", value=attr_tensor(W))
         + node("Uc", "Const", value=attr_tensor(U))
         + node("h0", "Const", value=attr_tensor(np.zeros((B, H))))
         + node("T_n", "Const", value=int_scalar_const(T))
         + node("zero_i", "Const", value=int_scalar_const(0))
         + node("one_i", "Const", value=int_scalar_const(1))
         + node("range_t", "Const", value=idx_t)
         + node("in_ta", "TensorArrayV3", ["T_n"], dtype=attr_type(1))
         + node("in_flow", "TensorArrayScatterV3",
                ["in_ta", "range_t", "x", "in_ta:1"])
         + node("out_ta", "TensorArrayV3", ["T_n"], dtype=attr_type(1))
         + enter("t_ent", ["zero_i"], "rnn")
         + enter("h_ent", ["h0"], "rnn")
         + enter("of_ent", ["out_ta:1"], "rnn")
         + node("t_mrg", "Merge", ["t_ent", "t_ni"])
         + node("h_mrg", "Merge", ["h_ent", "h_ni"])
         + node("of_mrg", "Merge", ["of_ent", "of_ni"])
         + node("lt", "Less", ["t_mrg", "T_n"])
         + node("lc", "LoopCond", ["lt"])
         + node("t_sw", "Switch", ["t_mrg", "lc"])
         + node("h_sw", "Switch", ["h_mrg", "lc"])
         + node("of_sw", "Switch", ["of_mrg", "lc"])
         + node("x_t", "TensorArrayReadV3", ["in_ta", "t_sw:1", "in_flow"])
         + node("xw", "MatMul", ["x_t", "Wc"])
         + node("hu", "MatMul", ["h_sw:1", "Uc"])
         + node("s", "Add", ["xw", "hu"])
         + node("h_new", "Tanh", ["s"])
         + node("of_w", "TensorArrayWriteV3",
                ["out_ta", "t_sw:1", "h_new", "of_sw:1"])
         + node("t_add", "Add", ["t_sw:1", "one_i"])
         + node("t_ni", "NextIteration", ["t_add"])
         + node("h_ni", "NextIteration", ["h_new"])
         + node("of_ni", "NextIteration", ["of_w"])
         + node("t_exit", "Exit", ["t_sw:0"])
         + node("h_exit", "Exit", ["h_sw:0"])
         + node("of_exit", "Exit", ["of_sw:0"])
         + node("ys", "TensorArrayGatherV3",
                ["out_ta", "range_t", "of_exit"])
         + node("out", "Identity", ["ys"]))
    return g, W, U


def cond_graph():
    """tf.cond: out = pred ? x * 2 : x + 1, through Switch and Merge."""
    return (node("x", "Placeholder")
            + node("pred", "Placeholder")
            + node("sw", "Switch", ["x", "pred"])
            + node("two", "Const", value=scalar_const(2.0))
            + node("one", "Const", value=scalar_const(1.0))
            + node("t", "Mul", ["sw:1", "two"])
            + node("f", "Add", ["sw:0", "one"])
            + node("m", "Merge", ["f", "t"])
            + node("out", "Identity", ["m"]))


def build_queue_graph(record_path, batch=8):
    """A GraphDef with its whole input pipeline in the graph:
    string_input_producer -> TFRecordReader -> DecodeRaw (5 floats a
    record) -> example queue -> QueueDequeueManyV2 -> a linear regression
    of the last float on the first four -> an in-graph MSE loss
    (``tfgraph_util.build_queue_graph``'s graph, node for node)."""
    g = b""
    g += node("filenames", "Const", value=string_const([record_path]))
    g += node("fq", "FIFOQueueV2")
    g += node("fq_enq", "QueueEnqueueManyV2", ["fq", "filenames"])
    g += node("reader", "TFRecordReaderV2")
    g += node("read", "ReaderReadV2", ["reader", "fq"])
    g += node("decoded", "DecodeRaw", ["read:1"], out_type=attr_type(1))
    g += node("rec", "Reshape", ["decoded", "rec_shape"])
    g += node("rec_shape", "Const", value=shape_const([5]))
    g += node("eq", "FIFOQueueV2")
    g += node("eq_enq", "QueueEnqueueV2", ["eq", "rec"])
    g += node("batch_n", "Const", value=int_scalar_const(batch))
    g += node("dq", "QueueDequeueManyV2", ["eq", "batch_n"])
    g += node("xb", "Const", value=shape_const([0, 0]))
    g += node("xs", "Const", value=shape_const([-1, 4]))
    g += node("x", "Slice", ["dq", "xb", "xs"])
    g += node("yb", "Const", value=shape_const([0, 4]))
    g += node("ys", "Const", value=shape_const([-1, 1]))
    g += node("y", "Slice", ["dq", "yb", "ys"])
    g += node("w_init", "Const", value=attr_tensor(np.zeros((4, 1))))
    g += node("W", "VariableV2")
    g += node("W_assign", "Assign", ["W", "w_init"])
    g += node("pred", "MatMul", ["x", "W"])
    g += node("diff", "Sub", ["pred", "y"])
    g += node("sq", "Square", ["diff"])
    g += node("red", "Const", value=shape_const([0, 1]))
    g += node("loss", "Mean", ["sq", "red"])
    return g
