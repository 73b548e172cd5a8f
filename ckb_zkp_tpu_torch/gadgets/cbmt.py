# Copied from ckb_zkp_tpu/gadgets/cbmt.py (host ints only): the port keeps its own copy.
"""Complete Binary Merkle Tree (Nervos CBMT) — native + in-circuit gadget.

Parity: ckb-zkp gadgets/src/merkletree/cbmt.rs:15-339 (tree build,
proof build, proof root recomputation, TreeIndex sibling/parent/is_left) and
cbmt_constraints.rs:11-115 (MerkleProofGadget.set_membership over any
AbstractHash). The merge function is a plain callable `(left, right) -> item`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Generic, TypeVar

from ..r1cs import ONE, ConstraintSystem
from .abstract_hash import AbstractHash, AbstractHashOutput

T = TypeVar("T")
Merge = Callable[[T, T], T]


# --- TreeIndex helpers (cbmt.rs:209-247) ---
def sibling(i: int) -> int:
    return 0 if i == 0 else ((i + 1) ^ 1) - 1


def parent(i: int) -> int:
    return 0 if i == 0 else (i - 1) >> 1


def is_left(i: int) -> bool:
    return i & 1 == 1


@dataclass
class MerkleProof(Generic[T]):
    """cbmt.rs:87-145 — tree-internal index + sibling lemmas bottom-up."""

    index: int
    lemmas: list[T]
    merge: Merge

    def root(self, leaf: T) -> T | None:
        if self.index == 0 and len(self.lemmas) != 0:
            return None
        node = leaf
        index = self.index
        for lemma in self.lemmas:
            if is_left(index):
                node = self.merge(node, lemma)
            else:
                node = self.merge(lemma, node)
            index = parent(index)
        return node

    def verify(self, root: T, leaf: T) -> bool:
        r = self.root(leaf)
        return r is not None and r == root


class MerkleTree(Generic[T]):
    """cbmt.rs:20-85 — nodes[0] is the root; leaves occupy the tail."""

    def __init__(self, nodes: list[T], merge: Merge):
        self.nodes = nodes
        self.merge = merge

    def root(self, default: T | None = None) -> T:
        return self.nodes[0] if self.nodes else default

    def build_proof(self, leaf_index: int) -> MerkleProof[T] | None:
        if not self.nodes:
            return None
        leaves_count = (len(self.nodes) >> 1) + 1
        index = leaves_count + leaf_index - 1
        if index >= (leaves_count << 1) - 1:
            return None
        lemmas: list[T] = []
        if index == 0:
            return MerkleProof(index, lemmas, self.merge)
        while True:
            lemmas.append(self.nodes[sibling(index)])
            index_parent = parent(index)
            if index_parent == 0:
                break
            index = index_parent
        # the reference keeps the original tree index in the proof
        leaves_index = leaves_count + leaf_index - 1
        return MerkleProof(leaves_index, lemmas, self.merge)


def build_merkle_tree(leaves: list[T], merge: Merge) -> MerkleTree[T]:
    """cbmt.rs:182-202."""
    n = len(leaves)
    if n == 0:
        return MerkleTree([], merge)
    nodes: list[T] = [None] * (n - 1) + list(leaves)
    for i in reversed(range(n - 1)):
        nodes[i] = merge(nodes[(i << 1) + 1], nodes[(i << 1) + 2])
    return MerkleTree(nodes, merge)


def build_merkle_root(leaves: list[T], merge: Merge, default: T | None = None) -> T:
    """cbmt.rs:158-180 — queue-based root without materializing the tree."""
    if not leaves:
        return default
    queue: deque[T] = deque()
    rem = len(leaves) % 2
    for i in range(len(leaves) - 2, rem - 1, -2):
        queue.append(merge(leaves[i], leaves[i + 1]))
    if rem:
        queue.appendleft(leaves[0])
    while len(queue) > 1:
        right = queue.popleft()
        left = queue.popleft()
        queue.append(merge(left, right))
    return queue.popleft()


def build_merkle_proof(leaves: list[T], index: int, merge: Merge) -> MerkleProof[T] | None:
    return build_merkle_tree(leaves, merge).build_proof(index)


class MerkleProofGadget:
    """cbmt_constraints.rs:11-115 — in-circuit set-membership check.

    For each level: allocate is_left, a conditional-select binding
    is_left*(parent - sibling) = input - sibling per limb, then hash the
    (parent, sibling) pair ordered by is_left; finally bind the last parent
    to the expected root limb-by-limb.
    """

    def __init__(self, index: int, lemmas: list[AbstractHashOutput], hasher: AbstractHash):
        self.index = index
        self.lemmas = lemmas
        self.hasher = hasher

    def set_membership(
        self, cs: ConstraintSystem, root: AbstractHashOutput, leaf: AbstractHashOutput
    ) -> None:
        node = leaf
        index = self.index
        for i, lemma in enumerate(self.lemmas):
            parent_vars = node.get_variables()
            parent_vals = node.get_variable_values()
            sib_vars = lemma.get_variables()
            sib_vals = lemma.get_variable_values()
            left = is_left(index)
            is_left_var = cs.alloc(f"is_left_variable[{i}]", int(left))
            input_vals = parent_vals if left else sib_vals
            input_vars = [
                cs.alloc(f"input_variable[{i}][{j}]", v)
                for j, v in enumerate(input_vals)
            ]
            for j in range(min(len(parent_vars), len(sib_vars))):
                cs.enforce(
                    f"is_left*(left[{i}][{j}]-right[{i}][{j}])=(input[{j}]-right[{i}][{j}])",
                    is_left_var,
                    parent_vars[j] - sib_vars[j],
                    input_vars[j] - sib_vars[j],
                )
            with cs.ns(f"hash_enforce_{'left' if left else 'right'}_{i}"):
                pair = [node, lemma] if left else [lemma, node]
                node = self.hasher.hash_enforce(cs, pair)
            index = parent(index)

        for k, (pv, rv) in enumerate(zip(node.get_variables(), root.get_variables())):
            cs.enforce(f"root_must_equal_last_parent_{k}", pv, ONE, rv)
