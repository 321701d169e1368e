"""The in-circuit GKR gadget and the Compile, Setup, Solve, Prove pipeline
(the counterpart of gkr_mimc_tpu/gadget/incircuit.py, after the
reference's prover/gadget/{circuit,gadget,cs,solution}.go).

A user circuit calls ``gadget.update_hasher(cs, state, msg)`` for each
MiMC hash, or ``update_hasher_batch`` for many. ``close`` pads the batch,
commits to every io (split MSM, Keccak, rho), proves the batch with the
port's GKR walk on the card, and emits the in-circuit GKR verification as
R1CS constraints (``snark.gkr``): N hashes cost the outer SNARK about
three constraints each plus the verifier's overhead, instead of 364 each.

The hash hint (the keyed permutations) and the GKR prover hint (witness,
walk, proof) run on the gadget's device, the card unless the caller names
another; the tracing, the in-circuit verifier and the Groth16 tier run on
the host.

gnark separates the symbolic Compile from the witness Solve; here both are
one eager pass over the ``RecordingCS``. ``compile()`` traces with a zero
commitment (the hints do not fire at gnark's compile either), ``solve()``
traces again with the setup's keys, so the commitment and rho are real;
the constraint structure of both passes is the same, which solve checks.

The InitialRandomness public input (wire 1) keeps the reference's
placeholder: it is traced as 0, the last constraint is the deliberately
unsatisfied ``1 * rho_pub == rho_computed``, and ``Solution.fix_solution``
patches wire 1 and that constraint's B value as solution.go:52-82 does.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import native
from ..circuits import circuit as circ_mod
from ..circuits.circuit import Circuit
from ..fields import fr
from ..gkr import prover as gkr_prover
from ..hashes.mimc import mimc_keyed_permutation, mimc_keyed_permutation_device
from ..models.mimc import mimc_circuit
from ..snark import gkr as snark_gkr
from ..snark.polynomial import MultiLin
from ..snark.r1cs import CompiledR1CS, RecordingCS, RVariable
from ..utils.common import log2_ceil
from ..utils.convert import ints_to_rows
from . import bn254_g1 as g1
from . import groth16 as groth16_mod
from .gadget import device_in_use, zero_output
from .groth16 import Groth16ProvingKey, Groth16VerifyingKey


class InCircuitIoStore:
    """The io store over RecordingCS variables: inputs by column, outputs;
    the dump order is inputs[0] || inputs[1] || ... || outputs."""

    def __init__(self, input_arity: int = 2):
        self.input_arity = input_arity
        self.inputs: list[list[RVariable]] = [[] for _ in range(input_arity)]
        self.outputs: list[RVariable] = []
        self.index = 0

    def push(self, inputs: list[RVariable], output: RVariable) -> None:
        if len(inputs) != self.input_arity:
            raise ValueError(f"{len(inputs)} inputs, the circuit takes {self.input_arity}")
        for i, v in enumerate(inputs):
            self.inputs[i].append(v)
        self.outputs.append(output)
        self.index += 1

    def dump_vars(self) -> list[RVariable]:
        res = []
        for col in self.inputs:
            res.extend(col)
        res.extend(self.outputs)
        return res

    def input_values(self) -> list[list[int]]:
        return [[v.value for v in col] for col in self.inputs]


def _wire_of(v: RVariable):
    """The single wire id of a freshly allocated variable, or None for a
    constant or a compound linear combination."""
    if v.is_constant or len(v.lc) != 1:
        return None
    w, c = v.lc[0]
    return w if c == 1 and w != 0 else None


def _enforce_wire(cs: RecordingCS, v: RVariable) -> RVariable:
    """Pin an io variable to a wire of its own (the fork's cs.EnforceWire):
    the commitment multiexps wire values, so a compound linear combination
    becomes a fresh wire plus one equality."""
    if v.is_constant or _wire_of(v) is not None:
        return v
    nv = cs.witness(v.value)
    cs.assert_is_equal(nv, v)
    return nv


class InCircuitGkrGadget:
    """The gadget over a RecordingCS (gadget.go:34-119)."""

    def __init__(self, circuit: Circuit | None = None, device="cuda"):
        """The default circuit is MiMC-91. Tensors go to ``device``, the
        card unless the caller names another; with no card the default
        raises."""
        self.device = device_in_use(device)
        self.circuit = circuit if circuit is not None else mimc_circuit()
        self.io = InCircuitIoStore(self.circuit.input_arity())

    def update_hasher(self, cs: RecordingCS, state, msg) -> RVariable:
        """One Miyaguchi-Preneel update: the keyed permutation is a hint (a
        fresh witness wire, computed on the host), the completion
        perm + 2 state + msg is linear."""
        state = _enforce_wire(cs, cs._lift(state))
        msg = _enforce_wire(cs, cs._lift(msg))
        perm_var = cs.witness(mimc_keyed_permutation(msg.value, state.value))
        self.io.push([state, msg], perm_var)
        return cs.add(perm_var, state, state, msg)

    def update_hasher_batch(self, cs: RecordingCS, states, msgs) -> list[RVariable]:
        """N independent updates with the hash hint fired once for the batch,
        on the device (91 ``cipher_layer`` launches); the constraints are
        those of N ``update_hasher`` calls."""
        if len(states) != len(msgs):
            raise ValueError("states and msgs must have equal length")
        svars = [_enforce_wire(cs, cs._lift(s)) for s in states]
        mvars = [_enforce_wire(cs, cs._lift(m)) for m in msgs]
        perms = mimc_keyed_permutation_device(fr.encode_mont_ints([v.value for v in mvars], self.device),
                                              fr.encode_mont_ints([v.value for v in svars], self.device))
        outs = []
        for sv, mv, p in zip(svars, mvars, fr.to_ints(perms)):
            perm_var = cs.witness(p)
            self.io.push([sv, mv], perm_var)
            outs.append(cs.add(perm_var, sv, sv, mv))
        return outs

    def _pad(self, cs: RecordingCS) -> int:
        """Pad to a power of two with constant entries (no wires): zero
        inputs and the circuit's own output on zeros. -> bN."""
        if self.io.index == 0:
            raise ValueError("close() on an empty gadget")
        bn = log2_ceil(self.io.index)
        zero = cs.constant(0)
        out = cs.constant(zero_output(self.circuit))
        while self.io.index < (1 << bn):
            self.io.push([zero] * self.io.input_arity, out)
        return bn

    def gkr_wire_ids(self) -> list[int]:
        """First-occurrence wire ids of the non-constant ios, in dump order."""
        seen, seen_set = [], set()
        for v in self.io.dump_vars():
            w = _wire_of(v)
            if w is not None and w not in seen_set:
                seen_set.add(w)
                seen.append(w)
        return seen

    def close(self, cs: RecordingCS, rho_pub: RVariable, commit_keys=None):
        """Pad, commit and derive rho, expand qPrime, prove on the device,
        emit the in-circuit verification and the placeholder constraint.

        commit_keys: None at compile time; at solve time
        (pub_points, priv_points, pub_wires, priv_wires) from the setup,
        the wires as trace ids. -> (rho, krs_gkr_priv)."""
        bn = self._pad(cs)

        krs_gkr_priv = g1.INF
        if commit_keys is None:
            rho = 0
        else:  # the InitialRandomnessHint
            pub_pts, priv_pts, pub_wires, priv_wires = commit_keys
            zvals = {w: None for w in pub_wires + priv_wires}
            for v in self.io.dump_vars():
                w = _wire_of(v)
                if w in zvals and zvals[w] is None:
                    zvals[w] = v.value
            krs_pub = native.msm(pub_pts, [zvals[w] for w in pub_wires])
            krs_gkr_priv = native.msm(priv_pts, [zvals[w] for w in priv_wires])
            rho = g1.derive_randomness_from_point(g1.add(krs_pub, krs_gkr_priv))
        rho_var = cs.witness(rho)

        qprime_vars = []  # qPrime by successive squaring, in constraints
        tmp = rho_var
        for _ in range(bn):
            qprime_vars.append(tmp)
            tmp = cs.mul(tmp, tmp)

        # the GkrProverHint: witness and proof on the device
        inputs = [fr.encode_mont_ints(col, self.device) for col in self.io.input_values()]
        qprime = ints_to_rows([v.value for v in qprime_vars], self.device)
        assignment = circ_mod.assign(self.circuit, inputs)
        proof = gkr_prover.prove(self.circuit, assignment, qprime)

        sproof = snark_gkr.Proof.assign(cs, self.circuit, proof)
        sproof.assert_valid(cs, self.circuit, qprime_vars, [MultiLin(col) for col in self.io.inputs],
                            MultiLin(self.io.outputs))

        # the placeholder the solver leaves for fix_solution:
        # 1 * InitialRandomness == rho, B traced as 0
        cs.raw_constraint(((0, 1),), tuple(rho_pub.lc), tuple(rho_var.lc), 1, 0, rho)
        return rho, krs_gkr_priv


@dataclass
class Solution:
    """The wire vector and the per-constraint values."""

    wires: list
    abc: list

    def fix_solution(self) -> None:
        """The last constraint must be the placeholder (a = 1, b = 0,
        c = rho != 0) and wire 1 unset; patch both."""
        a, b, c = self.abc[-1]
        errs = []
        if a != 1:
            errs.append(f"a[last] should be 1, got {a}")
        if b != 0:
            errs.append(f"b[last] should be 0, got {b}")
        if c == 0:
            errs.append("c[last] should be nonzero")
        if self.wires[1] != 0:
            errs.append(f"w[1] should be 0, got {self.wires[1]}")
        if errs:
            raise ValueError("; ".join(errs))
        self.abc[-1] = (a, c, c)
        self.wires[1] = c


@dataclass
class GadgetR1CS:
    """The R1CS and the GKR wire partition."""

    r1cs: CompiledR1CS
    pub_gkr: list
    priv_gkr: list
    pub_not_gkr: list
    priv_not_gkr: list
    bn: int

    @property
    def partition(self):
        return (self.pub_gkr, self.priv_gkr, self.pub_not_gkr, self.priv_not_gkr)


class GadgetCircuit:
    """WrapCircuitUsingGkr: ``define(cs, gadget)`` is the user circuit; the
    wrapper adds the public InitialRandomness (wire 1) and the gadget's
    close."""

    def __init__(self, define, circuit: Circuit | None = None, device="cuda"):
        """The hints run on ``device``, the card unless the caller names
        another; with no card the default raises."""
        self.define = define
        self.device = device_in_use(device)
        self.circuit = circuit if circuit is not None else mimc_circuit()

    def _trace(self, commit_keys=None):
        cs = RecordingCS()
        gadget = InCircuitGkrGadget(self.circuit, self.device)
        rho_pub = cs.public_input(0)  # wire 1
        self.define(cs, gadget)
        rho, krs_gkr_priv = gadget.close(cs, rho_pub, commit_keys)
        return cs, gadget, rho, krs_gkr_priv

    def compile(self) -> GadgetR1CS:
        """Trace with a zero commitment and build the GKR wire partition."""
        cs, gadget, _, _ = self._trace(commit_keys=None)
        r1cs = cs.compile()
        gkr_canon = {r1cs.wire_map[w] for w in gadget.gkr_wire_ids()}
        n_pub = r1cs.n_public
        pub = range(1, n_pub + 1)
        priv = range(n_pub + 1, r1cs.n_wires)
        return GadgetR1CS(
            r1cs=r1cs,
            pub_gkr=[w for w in pub if w in gkr_canon],
            priv_gkr=[w for w in priv if w in gkr_canon],
            pub_not_gkr=[w for w in pub if w not in gkr_canon],
            priv_not_gkr=[w for w in priv if w not in gkr_canon],
            bn=log2_ceil(max(gadget.io.index, 1)),
        )

    def solve(self, compiled: GadgetR1CS, pk: Groth16ProvingKey, vk: Groth16VerifyingKey):
        """Trace again with the commitment keys, check the structure matches
        the compiled one, fix the placeholder. -> (solution, krs_gkr_priv,
        rho)."""
        # the keys carry canonical wire ids, close() matches trace ids: the
        # solve trace allocates as the compile trace did, so map them back
        raw_of = {v: k for k, v in compiled.r1cs.wire_map.items()}
        commit_keys = (vk.pub_k_gkr, pk.priv_k_gkr_sigma, [raw_of[w] for w in vk.pub_gkr_wires],
                       [raw_of[w] for w in pk.priv_gkr_wires])
        cs, _, rho, krs_gkr_priv = self._trace(commit_keys=commit_keys)
        if cs.nb_constraints != len(compiled.r1cs.constraints):
            raise ValueError("solve trace diverged from the compiled structure: "
                             f"{cs.nb_constraints} vs {len(compiled.r1cs.constraints)}")
        remap = compiled.r1cs.wire_map
        wires = [0] * compiled.r1cs.n_wires
        for raw, v in enumerate(cs.wire_values):
            wires[remap[raw]] = v
        wires[0] = 1
        solution = Solution(wires=wires, abc=list(cs.abc))
        solution.fix_solution()
        return solution, krs_gkr_priv, rho

    def prove(self, compiled: GadgetR1CS, pk: Groth16ProvingKey, vk: Groth16VerifyingKey,
              seed: bytes | None = None):
        """Solve, check the solution against the R1CS, then the Groth16
        proof (fresh blinding unless a seed is given). -> (proof,
        public values)."""
        solution, krs_gkr_priv, rho = self.solve(compiled, pk, vk)
        solved = CompiledR1CS(constraints=compiled.r1cs.constraints, n_public=compiled.r1cs.n_public,
                              n_wires=compiled.r1cs.n_wires, abc=solution.abc, wires=solution.wires,
                              wire_map=compiled.r1cs.wire_map)
        solved.check()
        proof = groth16_mod.prove(solved, pk, krs_gkr_priv, rho, seed=seed)
        return proof, solution.wires[1 : compiled.r1cs.n_public + 1]


def setup(compiled: GadgetR1CS, seed: bytes | None = None):
    """Setup (``os.urandom`` toxic waste) or, with a seed, DummySetup."""
    return groth16_mod.setup(compiled.r1cs, compiled.partition, seed=seed)
